"""Host-side metric helpers."""
