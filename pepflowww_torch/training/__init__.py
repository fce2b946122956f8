"""Training: optimizer and plateau scheduler, the train step, checkpoints."""
