"""gather_weighted_sum: out[i] = Σ_j w[i, j] · x[slots[i, j]]
(counterpart: euler_tpu/ops/pallas_kernels.py:43-190).

The fused neighbor gather + weighted reduction of the SAGE-mean grid
path. On a CUDA tensor its forward runs the hand-written kernel in
`csrc/gather_weighted_sum.cu` (see the note there for its design and
bound); `gather_weighted_sum_ref` is its plain PyTorch version, which
the CPU runs and the tests and `chip_smoke.py` compare the kernel with.

Every impl goes through one `torch.autograd.Function` whose backward is
plain torch, as the JAX package's custom VJP is plain JAX
(pallas_kernels.py:166-187): dx is an `index_add_` of w·g accumulated in
f32 and cast to x's dtype, dw the per-slot dot of g with x[slots].
"""

from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch.ops import _build

NAME = "gather_weighted_sum"
IMPLS = ("auto", "ref", "cuda")

_bound_lib = None


def gather_weighted_sum_ref(
    x: torch.Tensor, slots: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """The plain version: f32 [N, F] from x [n_src, F] (f32 or bf16),
    slots int [N, D], w f32 [N, D]."""
    return torch.einsum("nd,ndf->nf", w, x[slots.long()].float())


def gather_weighted_sum(
    x: torch.Tensor, slots: torch.Tensor, w: torch.Tensor, impl: str = "auto"
) -> torch.Tensor:
    """impl: 'auto' (the kernel for CUDA tensors, the plain version for
    CPU tensors) | 'ref' (the plain version anywhere) | 'cuda' (the
    kernel; raises on CPU tensors). Never falls back from the kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    return _GatherWeightedSum.apply(x, slots, w, impl)


class _GatherWeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slots, w, impl):
        ctx.save_for_backward(x, slots, w)
        if impl == "ref":
            return gather_weighted_sum_ref(x, slots, w)
        return _launch(x, slots, w)

    @staticmethod
    def backward(ctx, g):
        x, slots, w = ctx.saved_tensors
        dx = dw = None
        g = g.float()
        if ctx.needs_input_grad[0]:
            contrib = w.float()[:, :, None] * g[:, None, :]  # [N, D, F]
            dx = (
                torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                .index_add_(0, slots.reshape(-1).long(), contrib.reshape(-1, x.shape[1]))
                .to(x.dtype)
            )
        if ctx.needs_input_grad[2]:
            dw = torch.einsum("nf,ndf->nd", g, x[slots.long()].float()).to(w.dtype)
        return dx, None, dw, None


def _lib():
    global _bound_lib
    if _bound_lib is None:
        lib = _build.load(NAME)
        fn = lib.euler_gws_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.euler_gws_error_string.argtypes = [ctypes.c_int]
        lib.euler_gws_error_string.restype = ctypes.c_char_p
        _bound_lib = lib
    return _bound_lib


def _check(x: torch.Tensor, slots: torch.Tensor, w: torch.Tensor) -> None:
    for name, t in (("x", x), ("slots", slots), ("w", w)):
        if not t.is_cuda:
            raise ValueError(
                f"gather_weighted_sum kernel needs CUDA tensors; {name} is on "
                f"{t.device} (use impl='ref' or 'auto' on the CPU)"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if slots.dtype != torch.int32:
        raise ValueError(f"slots must be int32, got {slots.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"w must be float32, got {w.dtype}")
    if slots.shape != w.shape:
        raise ValueError(
            f"slots {tuple(slots.shape)} and w {tuple(w.shape)} differ in shape"
        )
    if x.shape[1] == 0:
        raise ValueError("x has no feature columns")


def _launch(x: torch.Tensor, slots: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, slots, w)
    n_dst, d = slots.shape
    n_src, f = x.shape
    out = torch.empty((n_dst, f), dtype=torch.float32, device=x.device)
    if n_dst == 0:
        return out
    vec = 4 if f % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0 else 1
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.euler_gws_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), slots.data_ptr(),
            w.data_ptr(), out.data_ptr(), n_dst, d, f, n_src, vec, stream,
        )
    if rc != 0:
        msg = lib.euler_gws_error_string(rc).decode()
        raise RuntimeError(
            f"gather_weighted_sum launch failed (N={n_dst}, D={d}, F={f}): {msg}"
        )
    _build.count_launch(NAME)
    return out
