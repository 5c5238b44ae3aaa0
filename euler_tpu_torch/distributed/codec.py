"""Byte-path codec settings and the page quantizer (counterpart:
euler_tpu/distributed/codec.py:76-86, :286-375).

The page-dtype knob picks the representation of the device lane's
staged weight plane and of the feature cache's table; `quantize` /
`dequantize` turn f32 rows into those pages and back, within
`quant_error_budget`. numpy throughout, but for bf16: numpy has no bf16
dtype, so bf16 pages are torch bfloat16 tensors, rounded to nearest even
by torch, as ml_dtypes rounds them in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def page_dtype() -> str:
    """EULER_TPU_PAGE_DTYPE: feature page/wire quantization ("f32"
    exact default / "bf16" / "int8")."""
    name = os.environ.get("EULER_TPU_PAGE_DTYPE", "f32").strip() or "f32"
    if name not in ("f32", "bf16", "int8"):
        raise ValueError(
            f"EULER_TPU_PAGE_DTYPE={name!r}: expected f32, bf16, or int8"
        )
    return name


def _row_range(vals: np.ndarray):
    # per-row (min, max); zero-width rows quantize exactly to their lo
    if vals.shape[1] == 0:
        zero = np.zeros(len(vals), np.float32)
        return zero, zero
    return vals.min(axis=1), vals.max(axis=1)


def quantize(kind: str, vals: np.ndarray):
    """f32 [n, F] -> list of page arrays for `kind`: "f32" -> [vals]
    (exact); "bf16" -> [torch.bfloat16 vals]; "int8" -> [uint8 q, f32
    scale [n], f32 zero [n]] per-row affine."""
    vals = np.ascontiguousarray(vals, np.float32)
    if kind == "f32":
        return [vals]
    if kind == "bf16":
        return [torch.from_numpy(vals).to(torch.bfloat16)]
    if kind == "int8":
        if vals.ndim != 2:
            vals = vals.reshape(len(vals), -1)
        # the true per-row min / max: a range widened to include 0 would
        # blow the (rowmax - rowmin) / 254 budget of rows far from 0
        lo, hi = _row_range(vals)
        scale = np.maximum((hi - lo) / 255.0, np.float32(1e-30)).astype(np.float32)
        q = np.clip(np.rint((vals - lo[:, None]) / scale[:, None]), 0, 255).astype(np.uint8)
        return [q, scale, lo.astype(np.float32)]
    raise ValueError(f"unknown page dtype {kind!r}")


def dequantize(kind: str, parts) -> np.ndarray:
    """Inverse of `quantize` back to f32 (exact for f32, within
    `quant_error_budget` for bf16 / int8). Malformed part lists raise
    ValueError."""
    if kind == "f32":
        (vals,) = parts
        return np.ascontiguousarray(vals, np.float32)
    if kind == "bf16":
        (vals,) = parts
        return torch.as_tensor(vals).float().numpy()
    if kind == "int8":
        if len(parts) != 3:
            raise ValueError(f"int8 payload needs [q, scale, zero], got {len(parts)} arrays")
        q, scale, zero = parts
        q = np.asarray(q)
        if q.dtype != np.uint8:
            raise ValueError(f"int8 payload q plane has dtype {q.dtype}")
        return (q.astype(np.float32) * np.asarray(scale, np.float32)[:, None]
                + np.asarray(zero, np.float32)[:, None])
    raise ValueError(f"unknown page dtype {kind!r}")


def quant_error_budget(kind: str, vals: np.ndarray) -> np.ndarray:
    """Per-row max-abs-error budget: |dequantize(quantize(x)) - x| stays
    under it, elementwise."""
    vals = np.ascontiguousarray(vals, np.float32)
    if vals.ndim != 2:
        vals = vals.reshape(len(vals), -1)
    if kind == "f32":
        return np.zeros(len(vals), np.float32)
    if kind == "bf16":
        # one bf16 rounding: relative error <= 2^-9; 2^-8 leaves headroom
        # for subnormals
        return np.abs(vals).max(axis=1, initial=0.0) * np.float32(2**-8)
    if kind == "int8":
        lo, hi = _row_range(vals)
        return ((hi - lo) / 254.0).astype(np.float32)
    raise ValueError(f"unknown page dtype {kind!r}")
