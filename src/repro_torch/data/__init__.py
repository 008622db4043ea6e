"""Deterministic, checkpointable training data."""
