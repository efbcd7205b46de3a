"""Training on one device: the loss, AdamW, the step and checkpoints."""
