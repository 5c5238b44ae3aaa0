"""Message-passing ops and the kernel mode switch
(counterpart: euler_tpu/ops/__init__.py, `set_pallas`/`pallas_mode`).

Kernel modes, read by the layers that have a kernel path:
  'off'  — the scatter (segment-op) path; no fused kernel
  'ref'  — the fused path through each kernel's plain PyTorch version
  'cuda' — the fused path through the CUDA kernels; raises on CPU tensors
  'auto' — the kernels for CUDA tensors, the plain versions for CPU
           tensors (the default)
The paged sampling ops read the mode through `paged_impl` (counterpart:
`DeviceGraphTables._kimpl`): 'off' and 'ref' run their plain versions.
"""

from euler_tpu_torch.ops._build import (  # noqa: F401
    launch_counts,
    reset_launch_counts,
)
from euler_tpu_torch.ops.gather_weighted_sum import (  # noqa: F401
    gather_weighted_sum,
    gather_weighted_sum_dx,
    gather_weighted_sum_dx_ref,
    gather_weighted_sum_ref,
    launch_geometry,
)
from euler_tpu_torch.ops.mp_ops import (  # noqa: F401
    gather,
    scatter,
    scatter_add,
    scatter_max,
    scatter_mean,
    scatter_softmax,
)
from euler_tpu_torch.ops.paged import (  # noqa: F401
    PAGE_LANES,
    HopTables,
    as_lane_rows,
    pack_bf16_words,
    paged_cdf_count,
    paged_cdf_count_ref,
    paged_gather,
    paged_gather_dequant,
    paged_gather_dequant_ref,
    paged_gather_ref,
    paged_page_search,
    paged_sample_hop,
    paged_sample_hop_ref,
)
from euler_tpu_torch.ops.topk_score import (  # noqa: F401
    operand_range,
    order_keys,
    paged_topk_score,
    paged_topk_score_ref,
    paged_topk_select,
    paged_topk_select_ref,
    products_exact,
    topk_keys,
)

KERNEL_MODES = ("off", "ref", "cuda", "auto")
_KERNEL_MODE = "auto"


def set_kernel_mode(mode: str) -> None:
    global _KERNEL_MODE
    if mode not in KERNEL_MODES:
        raise ValueError(f"kernel mode must be one of {KERNEL_MODES}, got {mode!r}")
    _KERNEL_MODE = mode


def kernel_mode() -> str:
    return _KERNEL_MODE


def paged_impl() -> str:
    """The paged ops' impl under the current kernel mode."""
    return "ref" if _KERNEL_MODE == "off" else _KERNEL_MODE
