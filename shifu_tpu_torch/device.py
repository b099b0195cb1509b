"""Device selection for the port's entry points.

The card is the default.  Asking for CUDA where there is none raises: no
entry point silently drops to the CPU.  The CPU is used only when the caller
asks for it (the CPU tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda:0`; `"cpu"` -> the CPU; `"cuda[:N]"` -> that card.
    Raises RuntimeError for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
