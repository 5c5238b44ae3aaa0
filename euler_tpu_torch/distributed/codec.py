"""Byte-path codec settings (counterpart: euler_tpu/distributed/codec.py).

Only the page-dtype knob is ported: it picks the representation of the
device lane's staged weight plane and feature table.
"""

from __future__ import annotations

import os


def page_dtype() -> str:
    """EULER_TPU_PAGE_DTYPE: feature page/wire quantization ("f32"
    exact default / "bf16" / "int8")."""
    name = os.environ.get("EULER_TPU_PAGE_DTYPE", "f32").strip() or "f32"
    if name not in ("f32", "bf16", "int8"):
        raise ValueError(
            f"EULER_TPU_PAGE_DTYPE={name!r}: expected f32, bf16, or int8"
        )
    return name
