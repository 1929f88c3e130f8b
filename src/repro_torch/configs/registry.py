"""Architecture registry: ``--arch <id>`` → ModelConfig, plus the
cell-applicability matrix.  The port's copy of the JAX package's registry;
``repro_torch.models`` runs every family it lists (dense, VLM, MoE, SSM,
hybrid, enc-dec)."""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import (arctic_480b, dbrx_132b, gemma2_9b,
                                 h2o_danube_1_8b, mamba2_370m, minicpm3_4b,
                                 qwen2_vl_2b, qwen3_8b,
                                 seamless_m4t_large_v2, zamba2_7b)
from repro_torch.configs.base import SHAPE_CELLS, ModelConfig, ShapeCell

ARCHS: Dict[str, ModelConfig] = {
    "arctic-480b": arctic_480b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "mamba2-370m": mamba2_370m.CONFIG,
    "qwen3-8b": qwen3_8b.CONFIG,
    "gemma2-9b": gemma2_9b.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "h2o-danube-1.8b": h2o_danube_1_8b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
}

# Sub-quadratic archs run the 500k-context decode cell; pure full-attention
# archs skip it.
LONG_CONTEXT_ARCHS = {"mamba2-370m", "zamba2-7b", "h2o-danube-1.8b"}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def cells_for(name: str) -> List[ShapeCell]:
    cells = [SHAPE_CELLS["train_4k"], SHAPE_CELLS["prefill_32k"],
             SHAPE_CELLS["decode_32k"]]
    if name in LONG_CONTEXT_ARCHS:
        cells.append(SHAPE_CELLS["long_500k"])
    return cells


def all_cells() -> List[Tuple[str, ShapeCell]]:
    return [(a, c) for a in ARCHS for c in cells_for(a)]
