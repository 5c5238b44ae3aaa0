"""euler_tpu_torch — the PyTorch/CUDA port of euler_tpu.

The package mirrors `euler_tpu`'s module paths (graph, datasets, dataflow,
ops, layers, nn, models, serving, tools), so each module's counterpart is
found under the same name there. It imports torch and numpy only: nothing
of JAX and nothing of `euler_tpu`. Entry points run on the CUDA card
unless the caller passes `device="cpu"` (see `device.resolve_device`).

Every Pallas kernel of the JAX package becomes a kernel written for
Hopper under `ops/csrc/`, with a plain PyTorch version beside it that the
CPU runs and the tests compare against.
"""

from euler_tpu_torch.device import resolve_device  # noqa: F401
