"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu for NVIDIA Hopper.

A second package beside the JAX one (``heat_tpu``), which stays the
reference every part of the port is checked against. The port trains the
same SimpleX-style model — matrix factorization with a behaviour
aggregator, cosine scores and the pairwise logistic loss, SGD with a
clipped duplicate-safe row update — and evaluates it with a tiled exact
top-k, on one CUDA device (or the CPU, for tests).

The step's three row-irregular phases (row reads, history mean, row
scatter-add) are hand-written CUDA kernels for sm_90a
(``heat_tpu_torch/csrc``, bound in ``heat_tpu_torch.ops.cuda``); the rest
is plain PyTorch. The package imports torch and never jax.
"""

from heat_tpu_torch.config import CFConfig, load_config
from heat_tpu_torch.models.state import TrainState, init_train_state

__version__ = "0.1.0"

__all__ = [
    "CFConfig",
    "load_config",
    "TrainState",
    "init_train_state",
    "__version__",
]
