"""Where the port places what it builds: on the card unless asked otherwise.

The loaders and builders default to ``device="cuda"``; without a GPU they
raise instead of quietly placing a scene on the CPU, where every render
would then run the plain versions of the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises when no GPU is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available "
            "(pass device=\"cpu\" to place it on the CPU)"
        )
    return dev
