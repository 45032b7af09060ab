"""Activation functions (counterpart of ``heat_tpu/ops/activations.py``).

A numerically stable sigmoid and its gradient, for the loss variants that
use them (SigmoidPairwiseLoss).
"""

from __future__ import annotations

import torch


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable logistic function (branch-free where form of the
    positive/negative split)."""
    e = torch.exp(-torch.abs(x))
    return torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def sigmoid_grad(x: torch.Tensor) -> torch.Tensor:
    """d sigmoid / dx = s * (1 - s)."""
    s = sigmoid(x)
    return s * (1.0 - s)
