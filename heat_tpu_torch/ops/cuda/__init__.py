"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

The three row-irregular phases of a training step, the counterparts of the
Pallas kernels in ``heat_tpu/ops/pallas``:

* K1 ``gather.history_mean_gather`` — masked history mean fused with its
  gather (``csrc/gather.cu``);
* K2 ``gather.gather_rows`` — user, positive and negative row reads
  (``csrc/gather.cu``);
* K3 ``scatter.scatter_add_rows`` — duplicate-safe row scatter-add that
  builds the dense gradient accumulator (``csrc/scatter.cu``).

Each wrapper runs its plain PyTorch version (``*_ref``) for CPU tensors
and launches its kernel for CUDA tensors, never falling back from one to
the other, and counts its launches in its module's ``LAUNCHES``. The
sources are compiled by ``_build`` at the first launch.

No ``torch.autograd.Function`` wraps these kernels, because none of them
sits under a gradient in this slice: history rows never receive a
gradient, autograd runs over the gathered row tensors (leaves created
after K2), and K3 applies an update outside autograd. A kernel that does
need a backward (for example the attention aggregators' history gather)
goes into an ``autograd.Function`` in its wrapper module, with the
backward as a kernel of the same source file.
"""
