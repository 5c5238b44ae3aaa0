"""Retrieval's scorer and its per-tile top-K selection over a paged corpus
(counterpart: euler_tpu/ops/pallas_kernels.py:510-582, `paged_topk_score`,
and the `lax.top_k` after it in euler_tpu/retrieval/topk.py:88-92).

    scores[b, i] = sum over d of q[b, d] * x[i, d]

`table2d` is the [M, 128] lane-row view of a flat f32 buffer holding
`nrows` packed dp-wide vectors (`EmbeddingCorpus.lane_rows()`); anything
after nrows * dp is padding. The sum runs strictly left to right over d in
f32, a multiply and then an add each step, in every impl: that is the
contract that makes the kernel, the plain version, the JAX package and
the NumPy oracle agree bitwise on the corpus's 12-bit-significand
operands.

The kernel (`csrc/topk_score.cu`) has two templates of that step. The
mul/add template never fuses the two, so on the card it equals the plain
version for any f32 input; it is the default. `exact_products=True` picks
the FMA template: `fma(q, x, acc)` rounds once, `acc + q * x` rounds the
product and then the sum, and the two agree bit for bit (signed zeros
included) exactly when every product q * x is exact in f32. Two
significands of at most 12 bits make a product of at most 24 bits, which
f32 holds unless it falls below 2^-126 or overflows. `products_exact`
is the guard that shows this on the host from each operand's
`operand_range`: every value finite with a 12-bit significand,
min nonzero |q| * min nonzero |x| >= 2^-126 and max |q| * max |x| <= 2^127.
The caller passes `exact_products=True` only when it holds; the kernel
does not check it.

`paged_topk_select` is the first stage of a canonical top-K: for each
real query and each tile of `tile` rows, the tile's top min(k, tile) rows
in descending (score, -row) order, as int64 `order_keys`. A `torch.topk`
over those candidates (`topk_keys`) then gives `lax.top_k`'s answer over
the masked scores, ties at the k-th place included.

impl: 'auto' (the kernels on CUDA tensors, the plain versions on CPU
tensors), 'ref' (the plain versions anywhere) or 'cuda' (the kernels;
raise on CPU tensors). Nothing falls back from a kernel. The scorer takes
any dp >= 1, so every width `pad_dim` yields runs on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from euler_tpu_torch.ops import _build
from euler_tpu_torch.ops.paged import _resolve

NAME = "paged_topk_score"
SELECT = "paged_topk_select"
_LIBRARY = _build.KERNELS[NAME]
_bound: list[ctypes.CDLL] = []

# the selection kernel's tile on the retrieval path (256 threads x 32 rows),
# and a small one (256 x 4) that gives many tiles at small row counts
TILE = 8192
SMALL_TILE = 1024
TILES = (SMALL_TILE, TILE)

# the guard's limits: no product of two operands leaves the normal range
EXACT_MIN = 2.0**-126
EXACT_MAX = 2.0**127
_SIG12_LOW = np.uint32(0xFFF)
_ABS = np.uint32(0x7FFFFFFF)
_INF_BITS = 0x7F800000
_RANGE_CHUNK = 1 << 22

_LOW32 = 0xFFFFFFFF
KEY_PAD = -(2**63)  # below every real key: the order bits of -NaN and row 2^32 - 1


def operand_range(a) -> tuple[float, float] | None:
    """(least nonzero |a|, greatest |a|) of an f32 array whose every value
    is finite with a 12-bit significand (`quantize_sig12`); None when some
    value is not. An array without a nonzero value gives (inf, 0.0)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).reshape(-1).view(np.uint32)
    lo, hi = _INF_BITS, 0
    for i in range(0, bits.size, _RANGE_CHUNK):
        mag = bits[i:i + _RANGE_CHUNK] & _ABS
        if (mag & _SIG12_LOW).any():
            return None
        top = int(mag.max())
        if top >= _INF_BITS:
            return None
        hi = max(hi, top)
        nonzero = mag[mag != 0]
        if nonzero.size:
            lo = min(lo, int(nonzero.min()))
    return _bits_to_float(lo), _bits_to_float(hi)


def _bits_to_float(bits: int) -> float:
    return float(np.array(bits, dtype=np.uint32).view(np.float32))


def products_exact(q_range, x_range) -> bool:
    """The guard of the FMA template: every product of an operand in
    `q_range` with one in `x_range` (each from `operand_range`) is exact in
    f32, so FMA and the mul/add chain give the same bits."""
    if q_range is None or x_range is None:
        return False
    return q_range[0] * x_range[0] >= EXACT_MIN and q_range[1] * x_range[1] <= EXACT_MAX


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
    table2d: torch.Tensor, q: torch.Tensor, nrows: int, dp: int, impl: str = "auto",
    exact_products: bool = False,
) -> torch.Tensor:
    """[B, nrows] f32 scores of queries q [B, dp] against the `nrows`
    dp-wide vectors packed in table2d ([M, 128] f32 lane rows).
    `exact_products=True` runs the kernel's FMA template: pass it only when
    `products_exact` holds for these operands. The plain version has one
    form, which both templates equal."""
    nrows, dp = int(nrows), int(dp)
    if dp < 1 or nrows < 0:
        raise ValueError(f"need dp >= 1 and nrows >= 0, got dp={dp} nrows={nrows}")
    if q.ndim != 2 or q.shape[1] != dp:
        raise ValueError(f"queries must be [B, {dp}], got {tuple(q.shape)}")
    if table2d.numel() < nrows * dp:
        raise ValueError(f"table holds {table2d.numel()} elements, need {nrows} x {dp}")
    if _resolve(impl, table2d) == "ref":
        return paged_topk_score_ref(table2d, q, nrows, dp)
    _need_cuda(NAME, table=table2d, queries=q)
    if table2d.dtype != torch.float32 or not table2d.is_contiguous():
        raise ValueError(f"{NAME}: the table must be contiguous float32, got {table2d.dtype}")
    q = q.to(torch.float32).contiguous()
    out = torch.empty((q.shape[0], nrows), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    _launch(NAME, "euler_paged_topk_score_launch", out,
            table2d.data_ptr(), table2d.numel(), q.data_ptr(), out.data_ptr(),
            nrows, dp, q.shape[0], int(bool(exact_products)))
    return out


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys of [B, n] f32 scores whose order is (score desc, column
    asc): the float's order as a signed 32-bit integer in the high half,
    0xFFFFFFFF - column in the low half. Needs n < 2^32."""
    n = scores.shape[-1]
    key = scores.contiguous().view(torch.int32).to(torch.int64)
    key ^= (key >> 31) & 0x7FFFFFFF  # negative floats: flip the magnitude bits
    key *= 1 << 32
    key += _LOW32 - torch.arange(n, device=scores.device, dtype=torch.int64)
    return key


def topk_keys(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values f32, indices int64) [B, k] of the k largest `order_keys`
    per row, in order; values are decoded from the keys bit for bit."""
    top = torch.topk(keys, k, dim=1, largest=True, sorted=True).values
    idx = _LOW32 - (top & _LOW32)
    high = top >> 32
    bits = (high ^ ((high >> 31) & 0x7FFFFFFF)).to(torch.int32)
    return bits.view(torch.float32), idx


def _check_select(scores, b, k, mask, tile):
    if scores.ndim != 2:
        raise ValueError(f"{SELECT}: scores must be [B, nrows], got {tuple(scores.shape)}")
    if not 1 <= b <= scores.shape[0]:
        raise ValueError(f"{SELECT}: need 1 <= b <= {scores.shape[0]}, got b={b}")
    if k < 1:
        raise ValueError(f"{SELECT}: k must be positive, got {k}")
    if tile not in TILES:
        raise ValueError(f"{SELECT}: tile must be one of {TILES}, got {tile}")
    if scores.shape[1] >= _LOW32:
        raise ValueError(f"{SELECT}: needs fewer than 2^32 - 1 rows, got {scores.shape[1]}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (scores.shape[1],)):
        raise ValueError(f"{SELECT}: mask must be bool [{scores.shape[1]}], "
                         f"got {mask.dtype} {tuple(mask.shape)}")


def paged_topk_select_ref(scores: torch.Tensor, b: int, k: int, mask: torch.Tensor | None = None,
                          tile: int = TILE) -> torch.Tensor:
    """The plain version: canonical top-K (`order_keys`, `torch.topk`) on
    each tile of the masked first b rows of `scores`. Returns int64
    [b, ceil(nrows / tile), min(k, tile)]; a tile of fewer rows pads with
    KEY_PAD."""
    b, k, tile = int(b), int(k), int(tile)
    _check_select(scores, b, k, mask, tile)
    s = scores[:b].to(torch.float32)
    if mask is not None:
        s = torch.where(mask[None, :], s, float("-inf"))
    n = s.shape[1]
    ntiles, kt = -(-n // tile), min(k, tile)
    keys = torch.full((b, ntiles * tile), KEY_PAD, dtype=torch.int64, device=s.device)
    keys[:, :n] = order_keys(s)
    keys = keys.view(b, ntiles, tile)
    return torch.topk(keys, kt, dim=2, largest=True, sorted=True).values


def paged_topk_select(scores: torch.Tensor, b: int, k: int, mask: torch.Tensor | None = None,
                      tile: int = TILE, impl: str = "auto") -> torch.Tensor:
    """Stage 1 of the canonical top-K of the first b rows of `scores`
    [B, nrows] f32 (the rest are a bucket's padding and never read), rows
    outside the bool `mask` [nrows] scoring -inf: int64 [b, ntiles,
    min(k, tile)], bitwise what `paged_topk_select_ref` gives.
    `topk_keys(out.reshape(b, -1), min(k, nrows))` finishes it."""
    b, k, tile = int(b), int(k), int(tile)
    _check_select(scores, b, k, mask, tile)
    if _resolve(impl, scores) == "ref":
        return paged_topk_select_ref(scores, b, k, mask, tile)
    _need_cuda(SELECT, scores=scores, **({} if mask is None else {"mask": mask}))
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError(f"{SELECT}: scores must be contiguous float32, got {scores.dtype}")
    nrows = scores.shape[1]
    kt = min(k, tile)
    out = torch.empty((b, -(-nrows // tile), kt), dtype=torch.int64, device=scores.device)
    if out.numel() == 0:
        return out
    mask = None if mask is None else mask.contiguous()
    _launch(SELECT, "euler_paged_topk_select_launch", out,
            scores.data_ptr(), nrows, b, None if mask is None else mask.data_ptr(),
            out.data_ptr(), kt, tile)
    return out


def _need_cuda(name: str, **tensors) -> None:
    devices = set()
    for what, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"{name} kernel needs CUDA tensors; the {what} is on {t.device} "
                "(use impl='ref' or 'auto' on the CPU)"
            )
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")


def _launch(name: str, fn: str, out: torch.Tensor, *args) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.euler_topk_score_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed (shape {tuple(out.shape)}): {msg}")
    _build.count_launch(name)


def _lib() -> ctypes.CDLL:
    if not _bound:
        lib = _build.load(_LIBRARY)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.euler_paged_topk_score_launch.argtypes = [ptr, i64, ptr, ptr, i64, i32, i32, i32, ptr]
        lib.euler_paged_topk_score_launch.restype = i32
        lib.euler_paged_topk_select_launch.argtypes = [ptr, i64, i32, ptr, ptr, i32, i32, ptr]
        lib.euler_paged_topk_select_launch.restype = i32
        lib.euler_topk_score_error_string.argtypes = [i32]
        lib.euler_topk_score_error_string.restype = ctypes.c_char_p
        _bound.append(lib)
    return _bound[0]

