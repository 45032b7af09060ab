"""Tiled top-k evaluation and ranking metrics."""
