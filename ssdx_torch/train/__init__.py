"""Training: steps, LR schedule, checkpoints and the epoch loop."""
