"""paramugsy_tpu_torch: the PyTorch/CUDA port of paramugsy_tpu.

The pairwise (nucmer-role) path runs here end to end on one NVIDIA GPU:
codes upload to the device, one seeding + clustering pass of plain torch
ops, host chaining, and inter-anchor gap alignment whose long segments go
through two hand-written CUDA kernels (the anti-diagonal banded DP and its
traceback, `csrc/`).

Module names follow `paramugsy_tpu` so each counterpart is easy to find.
`paramugsy_tpu` stays the reference: modules of it that import no JAX
(`coords`, `formats`, `ops.native`, the host parts of `ops.extend`,
`utils.obs`) are imported from it, and host helpers of modules that do
import JAX are copied here.  Nothing in this package imports `jax`.

Every function that computes on tensors takes an explicit ``device``
(``"cuda"`` by default; ``"cpu"`` only when named, where each CUDA kernel
is replaced by its plain PyTorch version).
"""

__version__ = "0.1.0"
