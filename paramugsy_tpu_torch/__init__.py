"""paramugsy_tpu_torch: the PyTorch/CUDA port of paramugsy_tpu.

Two paths run here end to end on one NVIDIA GPU.  The pairwise
(nucmer-role) path: codes upload to the device, one seeding + clustering
pass of plain torch ops, host chaining, and inter-anchor gap alignment
whose long segments go through two hand-written CUDA kernels (the
anti-diagonal banded DP and its traceback, `csrc/`).  The sequential
multiple alignment (``align -sequential``, `pipeline.align_fastas`): a
guide tree from k-mer sketches multiplied on the device, then profile
merges fed by that pairwise path, with bridging and ``-refine`` gap
alignments on the same engines.  The row-banded DP of the reference
(`ops/banded.py`, one CUDA kernel for one pair or a batch) is ported too.

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
