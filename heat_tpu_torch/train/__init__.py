"""Training: negative sampling, the fused step, row updates, the engine."""
