"""Serving caches: the paged KV pool and the prompt prefix cache."""
