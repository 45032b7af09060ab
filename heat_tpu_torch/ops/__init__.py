"""Scoring, losses and the hand-written CUDA kernels (``ops.cuda``)."""
