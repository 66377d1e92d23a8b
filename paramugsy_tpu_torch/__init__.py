"""paramugsy_tpu_torch: the PyTorch/CUDA port of paramugsy_tpu.

Two paths run here end to end on one NVIDIA GPU.  The pairwise
(nucmer-role) path: codes upload to the device, one seeding + clustering
pass of plain torch ops, host chaining, and inter-anchor gap alignment
whose long segments go through two hand-written CUDA kernels (the
anti-diagonal banded DP and its traceback, `csrc/`).  The multiple
alignment (``align``): a guide tree from k-mer sketches multiplied on the
device, then profile merges fed by that pairwise path, with bridging and
``-refine`` gap alignments on the same engines, run by the concurrent
executor (`runtime/`: worker threads sharing the device, an artifact
store for ``-tmp_dir`` and resume) or, with ``-sequential``, by
`pipeline.align_fastas` in one thread.  The row-banded DP of the
reference (`ops/banded.py`, one CUDA kernel for one pair or a batch) is
ported too.

Module names follow `paramugsy_tpu` so each counterpart is easy to find.
`paramugsy_tpu` stays the reference, and this package imports nothing of
it: the host code it needs is copied here at the same relative path
(`coords`, `formats`, `profiles`, `lcb.score`, `tree.job_tree`,
`utils.obs`, `ops.native`, `runtime.{scheduler, backends, artifacts}`,
the LCB selection of `lcb.merge`, the guide tree of `tree.guide_tree`,
the NumPy NW of `ops.extend`), and host helpers
of the reference's JAX modules are copied into their counterparts.
Nothing in this package imports `jax`.

Every function that computes on tensors takes an explicit ``device``
(``"cuda"`` by default; ``"cpu"`` only when named, where each CUDA kernel
is replaced by its plain PyTorch version).
"""

__version__ = "0.1.0"
