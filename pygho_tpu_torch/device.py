"""Device choice for the port's entry points.

The port is written for a CUDA card.  An entry point runs there unless its
caller passes ``device="cpu"``; with no card and no explicit CPU request it
raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
