"""The retrieval scorer over a paged corpus
(counterpart: euler_tpu/ops/pallas_kernels.py:510-582, `paged_topk_score`).

    scores[b, i] = sum over d of q[b, d] * x[i, d]

`table2d` is the [M, 128] lane-row view of a flat f32 buffer holding
`nrows` packed dp-wide vectors (`EmbeddingCorpus.lane_rows()`); anything
after nrows * dp is padding. The sum runs strictly left to right over d in
f32, a multiply and then an add each step, in every impl: that is the
contract that makes the kernel, the plain version, the JAX package and
the NumPy oracle agree bitwise on the corpus's 12-bit-significand
operands. The kernel (`csrc/topk_score.cu`) never fuses the two into an
FMA, so on the card it equals the plain version for any f32 input.

impl: 'auto' (the kernel on CUDA tensors, the plain version on CPU
tensors), 'ref' (the plain version anywhere) or 'cuda' (the kernel; raises
on CPU tensors). Nothing falls back from the kernel. The kernel takes any
dp >= 1, so every width `pad_dim` yields runs on the card.
"""

from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch.ops import _build
from euler_tpu_torch.ops.paged import _resolve

NAME = "paged_topk_score"
_LIBRARY = _build.KERNELS[NAME]
_bound: list[ctypes.CDLL] = []


def paged_topk_score_ref(table2d: torch.Tensor, q: torch.Tensor, nrows: int, dp: int) -> torch.Tensor:
    """The plain version: the same left-to-right loop over d, one torch
    multiply and one add per step."""
    x = table2d.reshape(-1)[: nrows * dp].to(torch.float32).reshape(nrows, dp)
    q = q.to(torch.float32)
    acc = torch.zeros((q.shape[0], nrows), dtype=torch.float32, device=x.device)
    for d in range(dp):
        acc = acc + q[:, d, None] * x[None, :, d]
    return acc


def paged_topk_score(
    table2d: torch.Tensor, q: torch.Tensor, nrows: int, dp: int, impl: str = "auto"
) -> torch.Tensor:
    """[B, nrows] f32 scores of queries q [B, dp] against the `nrows`
    dp-wide vectors packed in table2d ([M, 128] f32 lane rows)."""
    nrows, dp = int(nrows), int(dp)
    if dp < 1 or nrows < 0:
        raise ValueError(f"need dp >= 1 and nrows >= 0, got dp={dp} nrows={nrows}")
    if q.ndim != 2 or q.shape[1] != dp:
        raise ValueError(f"queries must be [B, {dp}], got {tuple(q.shape)}")
    if table2d.numel() < nrows * dp:
        raise ValueError(f"table holds {table2d.numel()} elements, need {nrows} x {dp}")
    if _resolve(impl, table2d) == "ref":
        return paged_topk_score_ref(table2d, q, nrows, dp)
    for what, t in (("table", table2d), ("queries", q)):
        if not t.is_cuda:
            raise ValueError(
                f"{NAME} kernel needs CUDA tensors; the {what} is on {t.device} "
                "(use impl='ref' or 'auto' on the CPU)"
            )
    if q.device != table2d.device:
        raise ValueError(f"{NAME}: queries on {q.device}, table on {table2d.device}")
    if table2d.dtype != torch.float32 or not table2d.is_contiguous():
        raise ValueError(f"{NAME}: the table must be contiguous float32, got {table2d.dtype}")
    q = q.to(torch.float32).contiguous()
    out = torch.empty((q.shape[0], nrows), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        rc = lib.euler_paged_topk_score_launch(
            table2d.data_ptr(), table2d.numel(), q.data_ptr(), out.data_ptr(),
            nrows, dp, q.shape[0], stream,
        )
    if rc != 0:
        msg = lib.euler_topk_score_error_string(rc).decode()
        raise RuntimeError(f"{NAME} launch failed (shape {tuple(out.shape)}, dp {dp}): {msg}")
    _build.count_launch(NAME)
    return out


def _lib() -> ctypes.CDLL:
    if not _bound:
        lib = _build.load(_LIBRARY)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.euler_paged_topk_score_launch.argtypes = [ptr, i64, ptr, ptr, i64, i32, i32, ptr]
        lib.euler_paged_topk_score_launch.restype = i32
        lib.euler_topk_score_error_string.argtypes = [i32]
        lib.euler_topk_score_error_string.restype = ctypes.c_char_p
        _bound.append(lib)
    return _bound[0]
