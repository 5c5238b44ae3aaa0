"""Message-passing ops and the kernel mode switch
(counterpart: euler_tpu/ops/__init__.py, `set_pallas`/`pallas_mode`).

Kernel modes, read by the layers that have a kernel path:
  'off'  — the scatter (segment-op) path; no fused kernel
  'ref'  — the fused path through each kernel's plain PyTorch version
  'cuda' — the fused path through the CUDA kernels; raises on CPU tensors
  'auto' — the kernels for CUDA tensors, the plain versions for CPU
           tensors (the default)
"""

from euler_tpu_torch.ops._build import (  # noqa: F401
    launch_counts,
    reset_launch_counts,
)
from euler_tpu_torch.ops.gather_weighted_sum import (  # noqa: F401
    gather_weighted_sum,
    gather_weighted_sum_ref,
)
from euler_tpu_torch.ops.mp_ops import gather, scatter_add  # noqa: F401

KERNEL_MODES = ("off", "ref", "cuda", "auto")
_KERNEL_MODE = "auto"


def set_kernel_mode(mode: str) -> None:
    global _KERNEL_MODE
    if mode not in KERNEL_MODES:
        raise ValueError(f"kernel mode must be one of {KERNEL_MODES}, got {mode!r}")
    _KERNEL_MODE = mode


def kernel_mode() -> str:
    return _KERNEL_MODE
