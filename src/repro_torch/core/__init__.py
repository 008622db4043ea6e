"""Replacement policies: host oracles and the tensor decision core."""
