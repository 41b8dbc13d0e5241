"""Device resolution, shared by every entry point of the port.

The port has no implementation switch: the device of a tensor picks the
path. A tensor on the CPU takes a kernel's plain PyTorch version; a tensor
on a CUDA device takes the hand-written kernel, or the wrapper raises.
Entry points take ``device=``; ``None`` means the GPU, and a host without
one raises instead of falling back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Optional[Device] = None) -> torch.device:
    """``None`` -> ``cuda`` (raise if absent); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} requested but CUDA is not available")
    return device
