"""Training: the step (Adam, LR schedule, NaN guard) and the trainer."""
