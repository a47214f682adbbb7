"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The card unless the caller names another device.

    With no card and no explicit device this raises: the port never moves
    to the CPU on its own. Tests pass ``device="cpu"`` to run the plain torch
    versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain torch path")
        return torch.device("cuda")
    return torch.device(device)
