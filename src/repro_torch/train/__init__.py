"""The training loop: the microbatched step, checkpoints and the resilient
loop."""
