"""Device selection for the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The CUDA device unless the caller names one: `cuda:{LOCAL_RANK}` when a
    launcher (torchrun) set LOCAL_RANK, so that each rank of a node takes its
    own card, else `cuda`. Raises when no CUDA device exists and none was
    named: the port never moves to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "impx_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions instead")
    local_rank = os.environ.get("LOCAL_RANK")
    return torch.device("cuda" if local_rank is None else f"cuda:{int(local_rank)}")
