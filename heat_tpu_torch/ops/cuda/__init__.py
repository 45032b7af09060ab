"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

The row-irregular phases of a training step, the counterparts of the
Pallas kernels in ``heat_tpu/ops/pallas``, and the candidate extraction of
the exact top-k, the counterpart of the Pallas kernels in
``scripts/profile_eval.py``:

* K1 ``gather.history_mean_gather`` — masked history mean fused with its
  gather (``csrc/gather.cu``);
* K2 ``gather.gather_rows`` — user, positive and negative row reads, and
  the request rows of serving (``csrc/gather.cu``);
* K3 ``scatter.scatter_add_rows`` — duplicate-safe row scatter-add that
  builds the dense gradient accumulator (``csrc/scatter.cu``);
* K4 ``topk.window_extract`` — phase 2 of the two-phase exact top-k of
  evaluation and serving, the selected 128-wide score windows of each row
  (``csrc/topk.cu``).

Each wrapper runs its plain PyTorch version (``*_ref``) for CPU tensors
and launches its kernel for CUDA tensors, never falling back from one to
the other, and counts its launches in its module's ``LAUNCHES``. The
sources are compiled by ``_build`` at the first launch.

No ``torch.autograd.Function`` wraps these kernels, because none of them
sits under a gradient: history rows never receive a gradient, autograd
runs over the gathered row tensors (leaves created after K2), K3 applies
an update outside autograd, and K4 serves ranking only. A kernel that does
need a backward (for example the attention aggregators' history gather)
goes into an ``autograd.Function`` in its wrapper module, with the
backward as a kernel of the same source file.
"""
