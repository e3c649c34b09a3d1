"""Device selection for the port's entry points.

Every entry point takes `device="cuda"` by default. The CPU runs only when
a caller asks for it by name; a default call on a machine without CUDA
raises here instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; "cuda" becomes the current card's index."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
