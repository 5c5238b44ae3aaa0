"""Device selection for the PyTorch port.

Every entry point of the port takes a `device` argument and resolves it
here: the default is the CUDA card, and the CPU is used only when the
caller asks for it by name. A missing card is an error, never a reason to
carry on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` → "cuda"; anything else as given. Raises RuntimeError when
    a CUDA device is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
