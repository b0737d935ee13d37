"""The assigned input-shape presets (contract: 4 shapes × 10 archs = 40 cells).

``decode_*`` / ``long_*`` lower ``serve_step`` (one token against a seq_len
KV cache); ``train_*`` / ``prefill_*`` lower full-sequence steps.
``long_500k`` requires sub-quadratic sequence mixing and therefore only runs
for archs with cfg.sub_quadratic (zamba2, xlstm); the 8 pure-attention archs
record a principled skip (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapePreset:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapePreset] = {
    "train_4k": ShapePreset("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapePreset("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapePreset("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapePreset("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg, shape: ShapePreset) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is a pure full-attention arch (contract-mandated skip)"
        )
    return True, ""
