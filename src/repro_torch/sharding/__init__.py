"""Logical-axis sharding rules over a ``torch.distributed`` device mesh."""
