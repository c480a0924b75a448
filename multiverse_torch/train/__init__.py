"""Training of the port: optimizers and steps, evaluation, checkpoints."""
