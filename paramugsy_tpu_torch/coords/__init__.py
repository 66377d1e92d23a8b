from paramugsy_tpu_torch.coords.range import Range
from paramugsy_tpu_torch.coords.profile import Profile

__all__ = ["Range", "Profile"]
