"""Dense decoder layers, parameters and the prefill / decode paths."""
