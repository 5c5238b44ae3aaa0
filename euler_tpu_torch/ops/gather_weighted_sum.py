"""gather_weighted_sum: out[i] = Σ_j w[i, j] · x[slots[i, j]]
(counterpart: euler_tpu/ops/pallas_kernels.py:43-190).

The fused neighbor gather + weighted reduction of the SAGE-mean grid
path. On a CUDA tensor its forward runs the hand-written kernel in
`csrc/gather_weighted_sum.cu` (see the note there for its design and
bound); `gather_weighted_sum_ref` is its plain PyTorch version, which
the CPU runs and the tests and `chip_smoke.py` compare the kernel with.

Every impl goes through one `torch.autograd.Function`. Its backward
mirrors the JAX package's custom VJP (pallas_kernels.py:166-187): dx is
the scatter-add of w·g in f32, cast to x's dtype, dw the per-slot dot of
g with x[slots]. Where the forward ran the kernel, dx runs the
hand-written `gather_weighted_sum_dx` kernel of the same source; under
'ref' it runs the plain `gather_weighted_sum_dx_ref`. dw is plain torch
in every impl (the grid path's w comes from the mask and needs none).
"""

from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch.ops import _build

NAME = "gather_weighted_sum"
DX_NAME = "gather_weighted_sum_dx"
IMPLS = ("auto", "ref", "cuda")

_bound_lib = None


def gather_weighted_sum_ref(
    x: torch.Tensor, slots: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """The plain version: f32 [N, F] from x [n_src, F] (f32 or bf16),
    slots int [N, D], w f32 [N, D]."""
    return torch.einsum("nd,ndf->nf", w, x[slots.long()].float())


def gather_weighted_sum_dx_ref(
    w: torch.Tensor, g: torch.Tensor, slots: torch.Tensor, n_src: int, dtype: torch.dtype
) -> torch.Tensor:
    """The plain dx of the backward: dx[slots[i, j]] += w[i, j] · g[i],
    accumulated in f32 onto zeros [n_src, F] (an `index_add_` of the
    [N, D, F] product), then cast to `dtype`."""
    f = g.shape[1]
    contrib = w.float()[:, :, None] * g.float()[:, None, :]  # [N, D, F]
    return (
        torch.zeros((n_src, f), dtype=torch.float32, device=g.device)
        .index_add_(0, slots.reshape(-1).long(), contrib.reshape(-1, f))
        .to(dtype)
    )


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    return impl


def gather_weighted_sum(
    x: torch.Tensor, slots: torch.Tensor, w: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """impl: 'auto' (the kernel for CUDA tensors, the plain version for
    CPU tensors) | 'ref' (the plain version anywhere) | 'cuda' (the
    kernel; raises on CPU tensors). Never falls back from the kernel."""
    return _GatherWeightedSum.apply(x, slots, w, _resolve(impl, x))


def gather_weighted_sum_dx(
    w: torch.Tensor,
    g: torch.Tensor,
    slots: torch.Tensor,
    n_src: int,
    dtype: torch.dtype,
    impl: str = "auto",
) -> torch.Tensor:
    """dx [n_src, F] of `dtype`: dx[slots[i, j]] += w[i, j] · g[i] in f32.
    impl as for `gather_weighted_sum`; 'cuda' zeroes dx and launches the
    dx kernel, which never falls back."""
    if _resolve(impl, g) == "ref":
        return gather_weighted_sum_dx_ref(w, g, slots, n_src, dtype)
    return _launch_dx(w, g, slots, n_src, dtype)


class _GatherWeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slots, w, impl):
        ctx.save_for_backward(x, slots, w)
        ctx.impl = impl
        if impl == "ref":
            return gather_weighted_sum_ref(x, slots, w)
        return _launch(x, slots, w)

    @staticmethod
    def backward(ctx, g):
        x, slots, w = ctx.saved_tensors
        dx = dw = None
        g = g.float().contiguous()
        if ctx.needs_input_grad[0]:
            dx = gather_weighted_sum_dx(w, g, slots, x.shape[0], x.dtype, ctx.impl)
        if ctx.needs_input_grad[2]:
            dw = torch.einsum("nf,ndf->nd", g, x[slots.long()].float()).to(w.dtype)
        return dx, None, dw, None


def _lib():
    global _bound_lib
    if _bound_lib is None:
        lib = _build.load(NAME)
        launch_args = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.euler_gws_launch.argtypes = launch_args[:1] + [ctypes.c_int] + launch_args[1:]
        lib.euler_gws_dx_launch.argtypes = launch_args
        lib.euler_gws_geometry.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        for fn in (lib.euler_gws_launch, lib.euler_gws_dx_launch, lib.euler_gws_geometry):
            fn.restype = ctypes.c_int
        lib.euler_gws_error_string.argtypes = [ctypes.c_int]
        lib.euler_gws_error_string.restype = ctypes.c_char_p
        _bound_lib = lib
    return _bound_lib


def _vec(t: torch.Tensor) -> int:
    """Elements a lane loads at once from rows of `t`: 16 bytes (4 f32 or
    8 bf16) or 8 bytes (4 bf16) where the row width is a multiple and the
    buffer aligned to it, else 1."""
    f, size, ptr = t.shape[1], t.element_size(), t.data_ptr()
    for vec in (16 // size, 4):
        if f % vec == 0 and ptr % (vec * size) == 0:
            return vec
    return 1


def launch_geometry(t: torch.Tensor, slots: torch.Tensor) -> dict:
    """The launch shape of either kernel over rows of `t` (x for the
    forward, g for dx) and `slots` [N, D]: lanes a row, rows a block,
    blocks, threads a block and the load width."""
    n_dst, d = slots.shape
    vec = _vec(t)
    out = (ctypes.c_longlong * 4)()
    rc = _lib().euler_gws_geometry(t.shape[1], vec, n_dst, d, out)
    if rc != 0:
        raise RuntimeError(f"no gather_weighted_sum launch for F={t.shape[1]}, vec={vec}, "
                           f"N={n_dst}, D={d}")
    return {"lanes": out[0], "rows_per_block": out[1], "blocks": out[2],
            "threads": out[3], "vec": vec}


def _check(kernel: str, tensors: dict, dtypes: dict) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"{kernel} kernel needs CUDA tensors; {name} is on "
                f"{t.device} (use impl='ref' or 'auto' on the CPU)"
            )
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the others on {first.device}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in dtypes[name]:
            raise ValueError(f"{name} must be {' or '.join(map(str, dtypes[name]))}, got {t.dtype}")
    slots, w = tensors["slots"], tensors["w"]
    if slots.shape != w.shape:
        raise ValueError(
            f"slots {tuple(slots.shape)} and w {tuple(w.shape)} differ in shape"
        )
    if first.shape[1] == 0:
        raise ValueError(f"{kernel}: the rows have no feature columns")


def _run(kernel: str, fn, *args, n_dst: int, d: int, f: int) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _lib().euler_gws_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed (N={n_dst}, D={d}, F={f}): {msg}")
    _build.count_launch(kernel)


def _launch(x: torch.Tensor, slots: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    f32 = (torch.float32,)
    _check(NAME, {"x": x, "slots": slots, "w": w},
           {"x": (torch.float32, torch.bfloat16), "slots": (torch.int32,), "w": f32})
    n_dst, d = slots.shape
    n_src, f = x.shape
    out = torch.empty((n_dst, f), dtype=torch.float32, device=x.device)
    if n_dst == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _run(NAME, lib.euler_gws_launch,
             x.data_ptr(), int(x.dtype == torch.bfloat16), slots.data_ptr(), w.data_ptr(),
             out.data_ptr(), n_dst, d, f, n_src, _vec(x), stream, n_dst=n_dst, d=d, f=f)
    return out


def _launch_dx(
    w: torch.Tensor, g: torch.Tensor, slots: torch.Tensor, n_src: int, dtype: torch.dtype
) -> torch.Tensor:
    f32 = (torch.float32,)
    _check(DX_NAME, {"g": g, "slots": slots, "w": w},
           {"g": f32, "slots": (torch.int32,), "w": f32})
    n_dst, d = slots.shape
    if g.shape[0] != n_dst:
        raise ValueError(f"g has {g.shape[0]} rows, slots {n_dst}")
    f = g.shape[1]
    dx = torch.zeros((n_src, f), dtype=torch.float32, device=g.device)
    if n_dst > 0:
        lib = _lib()
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream(g.device).cuda_stream
            _run(DX_NAME, lib.euler_gws_dx_launch,
                 g.data_ptr(), slots.data_ptr(), w.data_ptr(), dx.data_ptr(),
                 n_dst, d, f, n_src, _vec(g), stream, n_dst=n_dst, d=d, f=f)
    return dx.to(dtype)
