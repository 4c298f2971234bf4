"""Training: the train step (loss, backward, clipping, Adam, parameter EMA),
the dev-pass eval step, LR schedules, npz checkpoints in the JAX package's
format, metrics, the qualitative hooks, the training loop (one process or
several) and the supervisor."""
