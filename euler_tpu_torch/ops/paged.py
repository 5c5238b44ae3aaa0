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


def _lib(library: str) -> ctypes.CDLL:
    lib = _bound_libs.get(library)
    if lib is None:
        lib = _build.load(library)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if library == "paged_gather":
            for fn in (lib.euler_paged_gather_launch, lib.euler_paged_gather_dequant_launch):
                fn.argtypes = [ptr, i64, ptr, ptr, i64, ptr]
                fn.restype = i32
        else:
            lib.euler_paged_cdf_count_launch.argtypes = [ptr, i64, ptr, ptr, ptr, i64, i32, i32, ptr]
            lib.euler_paged_cdf_count_launch.restype = i32
        err = getattr(lib, f"euler_{library}_error_string")
        err.argtypes = [i32]
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
