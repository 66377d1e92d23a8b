"""The sharded data plane (counterpart of paramugsy_tpu.parallel)."""
from paramugsy_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
