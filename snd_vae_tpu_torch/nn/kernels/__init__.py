"""Hand-written CUDA kernels for Hopper (sm_90a), the port's counterpart of
the JAX package's ``nn/pallas``.

  * ``motif_level3``: level 3 of the motif conv in one kernel
    (``fused_motif_level3``), its autograd wrapper ``motif_level3`` and the
    plain version ``motif_level3_plain``; the served path runs it;
  * ``motif_combine``: ``fused_motif_combine`` (K1), the autograd wrapper
    ``motif_combine`` (K2) and the plain version ``motif_combine_plain``,
    the literal counterparts of the TPU kernel, off the served path;
  * ``adj_matmul``: ``blocked_adj_matmul`` (K3, act(A @ X) or with W
    act(A @ (X W))), its autograd wrapper ``adj_matmul``, the plain version
    ``adj_matmul_plain`` and the launch plan ``adj_matmul_plan``;
  * ``build``: compiles ``csrc/*.cu`` with nvcc and loads them with ctypes.

Each wrapper counts its launches in an integer attribute ``launches``.
"""
