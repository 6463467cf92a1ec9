"""Architecture registry: ``--arch <id>`` resolution + shape definitions.

Counterpart of ``repro.configs``: the same ten architectures, with
dimensions only (no weights).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.models.config import ArchConfig, reduced

from .deepseek_v3_671b import CONFIG as _deepseek
from .granite_3_2b import CONFIG as _granite3
from .granite_8b import CONFIG as _granite8
from .internvl2_76b import CONFIG as _internvl
from .mamba2_2_7b import CONFIG as _mamba2
from .moonshot_v1_16b_a3b import CONFIG as _moonshot
from .qwen3_0_6b import CONFIG as _qwen3
from .seamless_m4t_medium import CONFIG as _seamless
from .yi_9b import CONFIG as _yi
from .zamba2_1_2b import CONFIG as _zamba2

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [_granite3, _granite8, _yi, _qwen3, _seamless, _moonshot,
              _deepseek, _zamba2, _internvl, _mamba2]
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_reduced(name: str, **overrides) -> ArchConfig:
    return reduced(get_config(name), **overrides)


def list_archs() -> List[str]:
    return sorted(ARCHS)


def cell_is_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch × shape) dry-run cell runs, and why not if skipped.

    long_500k needs sub-quadratic attention → only SSM/hybrid families run
    it; all other cells run.
    """
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention at 524288 would be "
                       "O(S^2); skipped per brief (pure full-attention arch)")
    return True, ""
