"""The reference's state -> the port's, so both packages compute from the
same inputs.

Takes reference objects by duck typing (dataclass fields, numpy arrays,
or JAX arrays, which numpy reads through ``np.asarray``) and imports
neither JAX nor the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paramugsy_tpu_torch.ops.extend import Scoring
from paramugsy_tpu_torch.ops.align_pair import AlignConfig
from paramugsy_tpu_torch.pipeline import PipelineConfig


def align_config(ref_cfg) -> AlignConfig:
    """Reference `AlignConfig` -> port `AlignConfig` (same field values)."""
    fields = dataclasses.asdict(ref_cfg)
    fields["scoring"] = Scoring(**fields["scoring"])
    return AlignConfig(**fields)


def pipeline_config(ref_cfg) -> PipelineConfig:
    """Reference `PipelineConfig` -> port `PipelineConfig` (same field
    values, its nested `AlignConfig` and `Scoring` included)."""
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    fields["align"] = align_config(ref_cfg.align)
    fields["dup_list"] = list(ref_cfg.dup_list)
    return PipelineConfig(**fields)


def codes(arr, device: str | torch.device) -> torch.Tensor:
    """A code array (numpy or reference device array) -> int8 tensor."""
    return torch.from_numpy(np.asarray(arr, dtype=np.int8).copy()).to(device)


def device_cache(ref_cache: dict, device: str | torch.device) -> dict:
    """A reference `device_cache` ((name, length) -> padded device codes)
    -> the port's cache of the same keys on `device`."""
    return {key: codes(arr, device) for key, arr in ref_cache.items()}
