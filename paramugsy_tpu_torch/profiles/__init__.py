from paramugsy_tpu_torch.profiles.make import profile_set_of_maf
from paramugsy_tpu_torch.profiles.translate import translate, translate_entry
from paramugsy_tpu_torch.profiles.untranslate import untranslate

__all__ = ["profile_set_of_maf", "translate", "translate_entry", "untranslate"]
