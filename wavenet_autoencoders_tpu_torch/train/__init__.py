"""Training: the train step (loss, backward, clipping, Adam, parameter EMA),
LR schedules, npz checkpoints in the JAX package's format, metrics and the
training loop."""
