"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A missing
GPU is an error, never a silent fall-back to the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())   # tensors report an index
    return d
