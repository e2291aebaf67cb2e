"""Float training, the shadow-weight fine-tune and checkpoints on one device."""
