"""Checkpoint tools: the TF1 tensor-bundle reader and the converter of
the reference's released TF1 checkpoints."""
