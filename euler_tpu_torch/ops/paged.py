"""Paged ragged-indirection ops of the device sampling lane
(counterpart: euler_tpu/ops/pallas_kernels.py:193-495).

The flat page buffers of `dataflow/device.py` (layout="paged") are viewed
as [M, PAGE_LANES] lane rows, as in the JAX package, so the staged buffers
of both packages compare element for element. Three entry points read them,
each a hand-written CUDA kernel on CUDA tensors with its plain PyTorch
version beside it (the CPU runs that, and the tests and `chip_smoke.py`
compare the kernel with it):

  paged_gather          `csrc/paged_gather.cu`     4-byte bit copy
  paged_gather_dequant  `csrc/paged_gather.cu`     bf16-in-u32 → f32
  paged_cdf_count       `csrc/paged_cdf_count.cu`  in-page CDF count

`paged_page_search` stays plain torch in every impl, as it stays plain XLA
in the JAX package.

uint32 data. torch has no unsigned compares, shifts or searchsorted for
uint32 on the CPU, so every u32 plane (the quantized CDF, the packed bf16
weight words) and the draws' random bits are held as int32 tensors with
the same bit patterns, which is what the kernels read. The plain versions
widen them to int64 (`& 0xFFFFFFFF`) before comparing; the page-boundary
array, which no kernel reads, is staged as int64 values.

Each entry point takes impl: 'auto' (the kernel on CUDA tensors, the plain
version on CPU tensors), 'ref' (the plain version anywhere) or 'cuda' (the
kernel; raises on CPU tensors). Nothing falls back from a kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from euler_tpu_torch.ops import _build

PAGE_LANES = 128
IMPLS = ("auto", "ref", "cuda")
_U32 = 0xFFFFFFFF

_bound_libs: dict[str, ctypes.CDLL] = {}


def as_lane_rows(flat: torch.Tensor) -> torch.Tensor:
    """Flat 4-byte-dtype buffer → [M, PAGE_LANES] lane-row view, zero
    padded (counterpart: `_as_lane_rows`)."""
    flat = flat.reshape(-1)
    pad = (-flat.shape[0]) % PAGE_LANES
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, PAGE_LANES)


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their uint32 values, as int64."""
    return t.long() & _U32


def pack_bf16_words(flat: torch.Tensor) -> torch.Tensor:
    """f32 1-D buffer → int32 words holding two bf16 each (low half = even
    index, high half = odd), rounded to nearest even as JAX's
    `astype(bfloat16)` rounds (counterpart: `pack_bf16_words`, which
    returns the same bits as uint32)."""
    half = flat.reshape(-1).to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    if half.shape[0] % 2:
        half = torch.cat([half, half.new_zeros(1)])
    pair = half.reshape(-1, 2)
    return pair[:, 0] | (pair[:, 1] << 16)


def unpack_bf16_words(word: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """The half of each int32 word that `odd` selects, widened to f32 by a
    16-bit shift: exact, bf16 being the top half of an f32."""
    return torch.where(odd, word & -65536, word << 16).view(torch.float32)


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    return impl


def _clamp_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    # as XLA clamps an out-of-range gather index
    return idx.long().clamp(0, n - 1)


# -- plain versions ----------------------------------------------------------


def paged_gather_ref(table2d: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
    flat = table2d.reshape(-1)
    return flat[_clamp_index(fidx, flat.shape[0])]


def paged_gather_dequant_ref(table2d: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
    flat = table2d.reshape(-1)
    fidx = fidx.to(torch.int32)
    word = flat[_clamp_index(fidx >> 1, flat.shape[0])]
    return unpack_bf16_words(word, (fidx & 1) == 1)


def paged_cdf_count_ref(
    q2d: torch.Tensor, page: torch.Tensor, rbits: torch.Tensor, page_size: int
) -> torch.Tensor:
    flat = q2d.reshape(-1)
    lanes = page.long()[..., None] * page_size + torch.arange(
        page_size, device=page.device
    )
    q = u32(flat[_clamp_index(lanes, flat.shape[0])])  # [W, k, P]
    return (q <= u32(rbits)[..., None]).sum(dim=-1, dtype=torch.int32)


# -- entry points ------------------------------------------------------------


def paged_gather(table2d: torch.Tensor, fidx: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """out[i, j] = flat(table2d)[fidx[i, j]]: the ragged gather through
    the page indirection. table2d: [M, 128] int32 or float32 lane rows;
    fidx: int32 [W, k] flat element indices (page * page_size + slot),
    clamped into range. Returns table2d's dtype, [W, k]."""
    if _resolve(impl, table2d) == "ref":
        return paged_gather_ref(table2d, fidx)
    _check(table2d, fidx, "paged_gather", (torch.int32, torch.float32))
    out = torch.empty(fidx.shape, dtype=table2d.dtype, device=fidx.device)
    _run("paged_gather", "euler_paged_gather_launch", out,
         table2d.data_ptr(), table2d.numel(), fidx.data_ptr(), out.data_ptr(), fidx.numel())
    return out


def paged_gather_dequant(table2d: torch.Tensor, fidx: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The bf16 twin of `paged_gather`: table2d is a [M, 128] int32 view
    of `pack_bf16_words` words and fidx indexes LOGICAL bf16 elements
    (word fidx >> 1, half fidx & 1). Returns f32 [W, k]."""
    if _resolve(impl, table2d) == "ref":
        return paged_gather_dequant_ref(table2d, fidx)
    _check(table2d, fidx, "paged_gather_dequant", (torch.int32,))
    out = torch.empty(fidx.shape, dtype=torch.float32, device=fidx.device)
    _run("paged_gather_dequant", "euler_paged_gather_dequant_launch", out,
         table2d.data_ptr(), table2d.numel(), fidx.data_ptr(), out.data_ptr(), fidx.numel())
    return out


def paged_cdf_count(
    q2d: torch.Tensor, page: torch.Tensor, rbits: torch.Tensor, page_size: int,
    impl: str = "auto",
) -> torch.Tensor:
    """In-page quantized-CDF inversion: out[i, j] = |{l < page_size :
    flat(q2d)[page[i, j] * page_size + l] <= rbits[i, j]}|, compared as
    uint32. q2d: [M, 128] int32 bit patterns; page: int32 [W, k]; rbits:
    int32 [W, k] bit patterns; page_size divides 128. Returns int32."""
    p = int(page_size)
    if p <= 0 or PAGE_LANES % p:
        raise ValueError(f"page_size must divide {PAGE_LANES}, got {p}")
    if _resolve(impl, q2d) == "ref":
        return paged_cdf_count_ref(q2d, page, rbits, p)
    _check(q2d, page, "paged_cdf_count", (torch.int32,))
    _check(q2d, rbits, "paged_cdf_count", (torch.int32,))
    if rbits.shape != page.shape:
        raise ValueError(f"rbits {tuple(rbits.shape)} and page {tuple(page.shape)} differ")
    vec = int(p % 4 == 0 and q2d.data_ptr() % 16 == 0)
    out = torch.empty(page.shape, dtype=torch.int32, device=page.device)
    _run("paged_cdf_count", "euler_paged_cdf_count_launch", out,
         q2d.data_ptr(), q2d.numel(), page.data_ptr(), rbits.data_ptr(), out.data_ptr(),
         page.numel(), p, vec)
    return out


def paged_page_search(
    bound: torch.Tensor, pstart: torch.Tensor, npages: torch.Tensor,
    rbits: torch.Tensor, iters: int,
) -> torch.Tensor:
    """[W, k] counts of each node's pages whose boundary (last valid
    quantized-CDF value) is <= rbits: the pages the draw skips. A
    branchless binary search with a fixed iteration count (`iters` >=
    bit_length(max pages per node) + 1), integer math only, so every
    device gives the same integers. bound: int64 [pages] u32 values;
    pstart, npages: int32 [W]; rbits: int32 [W, k] bit patterns."""
    r = u32(rbits)
    lo = pstart.long()[:, None].expand(r.shape)
    hi = lo + npages.long()[:, None]
    cap = bound.shape[0] - 1
    for _ in range(max(int(iters), 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        le = bound[mid.clamp_max(cap)] <= r
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
    return (lo - pstart.long()[:, None]).to(torch.int32)


# -- one hop of the paged draw -------------------------------------------------


class HopTables(NamedTuple):
    """The staged tables a paged draw reads (`DeviceGraphTables.hop_tables`,
    layout "paged"): deg int32 [N+1] and page_start int32 [N+2] by row+1;
    pages2d int32 [M, 128] neighbour rows (row+1, 0 = padding); for weighted
    graphs page_bound int64 [pages] (u32 values), page_q2d [M, 128] int32
    bits of the quantized CDF and page_w2d [M, 128] weights (int32 words of
    packed bf16 pairs when w_packed, else f32); page_cap, slot_cap the last
    page and slot; search_iters the page search's depth."""

    deg: torch.Tensor
    page_start: torch.Tensor
    pages2d: torch.Tensor
    page_bound: torch.Tensor | None
    page_q2d: torch.Tensor | None
    page_w2d: torch.Tensor | None
    page_size: int
    search_iters: int
    page_cap: int
    slot_cap: int
    unit_w: bool
    w_packed: bool


def _compose_hop(t: HopTables, cur: torch.Tensor, draw: torch.Tensor, impl: str):
    """The hop as the JAX package composes it (euler_tpu/dataflow/
    device.py:922-975): page search, in-page count, neighbour and weight
    gathers, the page reads under `impl`. With impl 'ref' it is the hop's
    plain version; with 'cuda' it is the composition of kernels 2-4 that
    `paged_sample_hop`'s kernel replaced, which `chip_smoke.py` times."""
    deg = t.deg[cur]
    ps = t.page_start[cur]
    P = t.page_size
    if t.unit_w:
        idx = (draw * deg[:, None]).to(torch.int32)
    else:
        npages = t.page_start[cur + 1] - ps
        pg = paged_page_search(t.page_bound, ps, npages, draw, t.search_iters)
        pgc = torch.minimum(pg, (npages[:, None] - 1).clamp_min(0))
        page = (ps[:, None] + pgc).clamp_max(t.page_cap)
        cnt = paged_cdf_count(t.page_q2d, page, draw, P, impl=impl)
        idx = pgc * P + cnt
    idx = torch.minimum(idx, (deg[:, None] - 1).clamp_min(0))
    fidx = (ps[:, None] * P + idx).clamp_max(t.slot_cap)
    live = deg[:, None] > 0
    nbr = torch.where(live, paged_gather(t.pages2d, fidx, impl=impl), 0).reshape(-1)
    ew = None
    if not t.unit_w:
        wvals = (
            paged_gather_dequant(t.page_w2d, fidx, impl=impl)
            if t.w_packed
            else paged_gather(t.page_w2d, fidx, impl=impl)
        )
        ew = torch.where(live, wvals, 0.0).reshape(-1).to(torch.bfloat16)
    return nbr, ew, idx


def paged_sample_hop_ref(t: HopTables, cur: torch.Tensor, draw: torch.Tensor):
    """Plain version of `paged_sample_hop`: the plain versions of kernels
    2-4 and `paged_page_search`, composed as the JAX package composes them."""
    return _compose_hop(t, cur, draw, "ref")


def paged_sample_hop(t: HopTables, cur: torch.Tensor, draw: torch.Tensor, impl: str = "auto"):
    """One hop of the paged draw: [W] source rows (row+1 space, int32) and
    their [W, k] draws (int32 bit patterns of u32 random bits, or f32
    uniforms on unit-weight tables) → ([W·k] int32 neighbour rows, [W·k]
    bf16 edge weights or None for unit weights, [W, k] int32 slot index).
    Weighted rows invert their quantized CDF (page search, then in-page
    count); unit-weight rows scale the uniforms by the degree. Padding rows
    (degree 0) yield row 0 and weight +0.0. On CUDA tensors one launch of
    `csrc/paged_sample_hop.cu`, bitwise equal to `paged_sample_hop_ref`."""
    if _resolve(impl, cur) == "ref":
        return paged_sample_hop_ref(t, cur, draw)
    w, k = _check_hop(t, cur, draw)
    dev = cur.device
    nbr = torch.empty(w * k, dtype=torch.int32, device=dev)
    idx = torch.empty((w, k), dtype=torch.int32, device=dev)
    ew = None if t.unit_w else torch.empty(w * k, dtype=torch.bfloat16, device=dev)
    if t.unit_w:
        plane, vec, bound, q, wts = 0, 0, None, None, None
    else:
        plane = 2 if t.w_packed else 1
        vec = int(t.page_size % 4 == 0 and t.page_q2d.data_ptr() % 16 == 0)
        bound, q, wts = t.page_bound, t.page_q2d, t.page_w2d

    def buf(x):
        return (None, 0) if x is None else (x.data_ptr(), x.numel())

    n_rows = min(t.deg.numel(), t.page_start.numel() - 1)
    _run("paged_sample_hop", "euler_paged_sample_hop_launch", nbr,
         cur.data_ptr(), w, k, draw.data_ptr(), t.deg.data_ptr(), t.page_start.data_ptr(),
         n_rows, *buf(bound), *buf(q), *buf(t.pages2d), *buf(wts), t.page_size, t.page_cap,
         t.slot_cap, plane, vec, nbr.data_ptr(), None if ew is None else ew.data_ptr(),
         idx.data_ptr())
    return nbr, ew, idx


# -- kernel launch -----------------------------------------------------------


def _check(table: torch.Tensor, idx: torch.Tensor, name: str, dtypes) -> None:
    for what, t in (("table", table), ("index", idx)):
        if not t.is_cuda:
            raise ValueError(
                f"{name} kernel needs CUDA tensors; the {what} is on {t.device} "
                "(use impl='ref' or 'auto' on the CPU)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: the {what} must be contiguous")
    if idx.device != table.device:
        raise ValueError(f"{name}: index on {idx.device}, table on {table.device}")
    if table.dtype not in dtypes:
        raise ValueError(f"{name}: table must be one of {dtypes}, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: indices must be int32, got {idx.dtype}")
    if table.numel() == 0:
        raise ValueError(f"{name}: empty table")


def _check_hop(t: HopTables, cur: torch.Tensor, draw: torch.Tensor) -> tuple[int, int]:
    """(W, k) of a hop the kernel can take; raises on anything else."""
    name = "paged_sample_hop"
    if draw.dim() != 2 or cur.shape != draw.shape[:1]:
        raise ValueError(f"{name}: cur {tuple(cur.shape)} and draw {tuple(draw.shape)} "
                         "must be [W] and [W, k]")
    p = int(t.page_size)
    if p <= 0 or PAGE_LANES % p:
        raise ValueError(f"page_size must divide {PAGE_LANES}, got {p}")
    want = {"cur": (cur, torch.int32), "deg": (t.deg, torch.int32),
            "page_start": (t.page_start, torch.int32), "pages2d": (t.pages2d, torch.int32),
            "draw": (draw, torch.float32 if t.unit_w else torch.int32)}
    if not t.unit_w:
        want.update(page_bound=(t.page_bound, torch.int64), page_q2d=(t.page_q2d, torch.int32),
                    page_w2d=(t.page_w2d, torch.int32 if t.w_packed else torch.float32))
    for what, (x, dtype) in want.items():
        if x is None or not x.is_cuda:
            raise ValueError(
                f"{name} kernel needs CUDA tensors; {what} is "
                f"{'missing' if x is None else f'on {x.device}'} (use impl='ref' or 'auto' on the CPU)"
            )
        if x.device != cur.device:
            raise ValueError(f"{name}: {what} on {x.device}, cur on {cur.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if x.dtype != dtype:
            raise ValueError(f"{name}: {what} must be {dtype}, got {x.dtype}")
        if x.numel() == 0 and what not in ("cur", "draw"):
            raise ValueError(f"{name}: empty {what}")
    return draw.shape[0], draw.shape[1]


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# library → {launch symbol: argument types}; the last argument is the stream
_SIGNATURES = {
    "paged_gather": {
        "euler_paged_gather_launch": [_PTR, _I64, _PTR, _PTR, _I64, _PTR],
        "euler_paged_gather_dequant_launch": [_PTR, _I64, _PTR, _PTR, _I64, _PTR],
    },
    "paged_cdf_count": {
        "euler_paged_cdf_count_launch": [_PTR, _I64, _PTR, _PTR, _PTR, _I64, _I32, _I32, _PTR],
    },
    "paged_sample_hop": {
        "euler_paged_sample_hop_launch": [
            _PTR, _I64, _I32, _PTR, _PTR, _PTR, _I64,  # cur, W, k, draw, deg, page_start, rows
            _PTR, _I64, _PTR, _I64, _PTR, _I64, _PTR, _I64,  # bound, q, pages, weights
            _I32, _I32, _I32, _I32, _I32,  # P, page_cap, slot_cap, plane, vec
            _PTR, _PTR, _PTR, _PTR,  # nbr, ew, idx, stream
        ],
    },
}


def _lib(library: str) -> ctypes.CDLL:
    lib = _bound_libs.get(library)
    if lib is None:
        lib = _build.load(library)
        for symbol, argtypes in _SIGNATURES[library].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = _I32
        err = getattr(lib, f"euler_{library}_error_string")
        err.argtypes = [_I32]
        err.restype = ctypes.c_char_p
        _bound_libs[library] = lib
    return lib


def _run(name: str, symbol: str, out: torch.Tensor, *args) -> None:
    """Launch kernel `name` on the current stream of `out`'s device and
    count it; raises with the CUDA error on a refused launch. An empty
    output launches nothing."""
    if out.numel() == 0:
        return
    library = _build.KERNELS[name]
    lib = _lib(library)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        rc = getattr(lib, symbol)(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"euler_{library}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed (shape {tuple(out.shape)}): {msg}")
    _build.count_launch(name)
