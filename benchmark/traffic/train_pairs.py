"""Training batches drawn on the device: chip_smoke.py's `train_pairs`
(image 1 holds a permuted, lightly noised copy of half of image 0's valid
keypoints and fresh keypoints elsewhere; matching_mask marks the copies and
sends every other valid keypoint to the dustbin), vectorised over the batch.

A mix (benchmark/traffic/<name>.json, "generator": "train_pairs") gives:
  pairs      pairs a batch
  slots      keypoint slots an image
  padded     [low, high]: padded slots an image; the pool's images take the
             counts of an even spread over [low, high], in an order drawn
             from the seed, so every seed runs the same work
  match_frac share of min(valid0, valid1) copied into image 1
  desc_noise the copies' descriptor noise (descriptors are unit-variance)
  pool       distinct batches, cycled by the loop"""
from __future__ import annotations

import torch

from benchlib.core import spread_counts


def _random_order(generator, valid: torch.Tensor) -> torch.Tensor:
    """Each row's slots in an order drawn from the generator, valid slots first."""
    r = torch.rand(valid.shape, generator=generator, device=valid.device)
    return torch.argsort(torch.where(valid, r, 2.0), dim=1)


def one_batch(generator, b: int, n: int, d: int, nv0, nv1, match_frac: float, desc_noise: float) -> dict:
    dev = nv0.device
    g = dict(generator=generator, device=dev)
    d0, d1 = torch.randn((2, b, n, d), **g)
    k0, k1 = torch.rand((2, b, n, 2), **g) - 0.5
    s0, s1 = torch.rand((2, b, n), **g)
    slots = torch.arange(n, device=dev)
    valid0, valid1 = slots[None] < nv0[:, None], slots[None] < nv1[:, None]
    m = (torch.minimum(nv0, nv1).float() * match_frac).long()
    src, dst = _random_order(generator, valid0), _random_order(generator, valid1)
    sel = slots[None] < m[:, None]                      # the j-th pick copies src[j] to dst[j]

    def copy(x0, x1, noise):
        rows = lambda t, i: torch.gather(t, 1, i.view(i.shape + (1,) * (t.dim() - 2)).expand_as(t))  # noqa: E731
        new = rows(x0, src) + noise
        keep = rows(x1, dst)
        s = sel.view(sel.shape + (1,) * (x1.dim() - 2))
        return x1.scatter(1, dst.view(dst.shape + (1,) * (x1.dim() - 2)).expand_as(x1), torch.where(s, new, keep))

    d1 = copy(d0, d1, desc_noise * torch.randn((b, n, d), **g))
    k1 = copy(k0, k1, 0.0)
    s1 = copy(s0, s1, 0.0)
    gt = torch.zeros((b, n + 1, n + 1), device=dev)
    gt.view(b, -1).scatter_(1, src * (n + 1) + dst, sel.float())
    matched0 = torch.zeros_like(valid0).scatter(1, src, sel)
    matched1 = torch.zeros_like(valid1).scatter(1, dst, sel)
    gt[:, :n, n] = (valid0 & ~matched0).float()
    gt[:, n, :n] = (valid1 & ~matched1).float()
    return {"descriptors0": d0, "descriptors1": d1, "norm_keypoints0": k0, "norm_keypoints1": k1,
            "scores0": s0, "scores1": s1, "valid0": valid0, "valid1": valid1, "matching_mask": gt}


def make_pool(mix: dict, dim: int, generator, device) -> list[dict]:
    b, n, pool = mix["pairs"], mix["slots"], mix["pool"]
    low, high = mix["padded"]
    pads = spread_counts(generator, low, high, 2 * b * pool, device).view(pool, 2, b)
    return [one_batch(generator, b, n, dim, n - pads[i, 0], n - pads[i, 1], mix["match_frac"], mix["desc_noise"])
            for i in range(pool)]
