"""Keypoint coordinate normalizations (impx/geometry/keypoints.py)."""
from __future__ import annotations

import torch


def normalize_keypoints(kpts: torch.Tensor, height, width, scale: float = 0.7) -> torch.Tensor:
    """Center + 0.7*max-dim scaling. kpts [..., N, 2] in (x, y) pixels."""
    size = torch.tensor([width, height], dtype=kpts.dtype, device=kpts.device)
    center = size / 2.0
    scaling = size.max() * scale
    return (kpts - center) / scaling


def normalize_size(x: torch.Tensor, size, scale: float = 1.0) -> torch.Tensor:
    """(x - size/2 - 0.5) / (max(size)*scale); size = (w, h)."""
    size = torch.as_tensor(size, dtype=x.dtype, device=x.device).reshape(1, 2)
    return (x - size / 2.0 - 0.5) / (size.max() * scale)


def normalize_size_spg(x: torch.Tensor, size) -> torch.Tensor:
    return normalize_size(x, size, scale=0.7)


def normalize_intrinsic(x: torch.Tensor, K) -> torch.Tensor:
    """Pixel -> normalized camera coordinates: (x - c) / f."""
    K = torch.as_tensor(K, dtype=x.dtype, device=x.device)
    c = torch.stack([K[0, 2], K[1, 2]])
    f = torch.stack([K[0, 0], K[1, 1]])
    return (x - c) / f
