"""Matchable two-view pairs drawn on the device: a frozen copy of
impx_torch/data/synthetic_device.py (`draw_scene`, `feed_from_draws`,
`rotation_from_axis_angle`), plus the validity of padded keypoint slots.

A mix (benchmark/traffic/<name>.json, "generator": "scene_pairs") gives:
  pairs        pairs a call
  slots        keypoint slots an image (the padded bucket)
  valid        [low, high]: valid keypoints an image; the pool's images take
               the counts of an even spread over [low, high], in an order
               drawn from the seed, so every seed runs the same work
  inlier_frac  share of each image's keypoints with a true correspondence
               (the first ones, always valid)
  desc_scale   the descriptors' scale (unit norm times this)
  desc_noise, pixel_noise, image_size   as synthesize_feed_device's
  pool         distinct batches, cycled by the loop"""
from __future__ import annotations

import torch

from benchlib.core import spread_counts


def rotation_from_axis_angle(axis: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-12)
    ang = torch.deg2rad(angle_deg)
    zero = torch.zeros_like(ang)
    K = torch.stack([
        torch.stack([zero, -axis[:, 2], axis[:, 1]], -1),
        torch.stack([axis[:, 2], zero, -axis[:, 0]], -1),
        torch.stack([-axis[:, 1], axis[:, 0], zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(axis.shape[0], 3, 3)
    s = torch.sin(ang)[:, None, None]
    c = torch.cos(ang)[:, None, None]
    return eye + s * K + (1.0 - c) * (K @ K)


def draw_scene(generator, batch: int, n_kpts: int, dim: int, inlier_frac: float, image_size, device):
    h, w = image_size
    n_in = int(n_kpts * inlier_frac)
    n_out = n_kpts - n_in
    f32 = dict(generator=generator, device=device, dtype=torch.float32)

    def uniform(shape, low=0.0, high=1.0):
        return torch.rand(shape, **f32) * (high - low) + low

    return {
        "axis": torch.randn((batch, 3), **f32),
        "angle_deg": uniform((batch,), 5.0, 60.0),
        "t": torch.randn((batch, 3), **f32),
        "z": uniform((batch, n_in), 4.0, 12.0),
        "xp": uniform((batch, n_in), 0.2 * w, 0.8 * w),
        "yp": uniform((batch, n_in), 0.2 * h, 0.8 * h),
        "noise0": torch.randn((batch, n_in, 2), **f32),
        "noise1": torch.randn((batch, n_in, 2), **f32),
        "out0": uniform((batch, n_out, 2)),
        "out1": uniform((batch, n_out, 2)),
        "shared": torch.randn((batch, n_in, dim), **f32),
        "noise_d0": torch.randn((batch, n_in, dim), **f32),
        "noise_d1": torch.randn((batch, n_in, dim), **f32),
        "d0_out": torch.randn((batch, n_out, dim), **f32),
        "d1_out": torch.randn((batch, n_out, dim), **f32),
        "s0": uniform((batch, n_kpts), 0.1, 1.0),
        "s1": uniform((batch, n_kpts), 0.1, 1.0),
    }


def feed_from_draws(draws, image_size, desc_noise: float, pixel_noise: float) -> dict:
    h, w = image_size
    f = 0.9 * max(h, w)
    cx, cy = w / 2.0, h / 2.0
    dev = draws["t"].device
    R = rotation_from_axis_angle(draws["axis"], draws["angle_deg"])
    t = draws["t"] / (torch.linalg.norm(draws["t"], dim=-1, keepdim=True) + 1e-12)
    z, xp, yp = draws["z"], draws["xp"], draws["yp"]
    X = torch.stack([(xp - cx) / f * z, (yp - cy) / f * z, z], -1)
    baseline = 0.3 * z.mean(dim=1)
    X1 = torch.einsum("bnk,bjk->bnj", X, R) + (t * baseline[:, None])[:, None, :]
    centre = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    u1 = X1[..., :2] / torch.clamp(X1[..., 2:3], min=0.1) * f + centre
    x0_in = torch.stack([xp, yp], -1) + pixel_noise * draws["noise0"]
    x1_in = u1 + pixel_noise * draws["noise1"]
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    shared = draws["shared"]
    d0 = torch.cat([shared + desc_noise * draws["noise_d0"], draws["d0_out"]], 1)
    d1 = torch.cat([shared + desc_noise * draws["noise_d1"], draws["d1_out"]], 1)

    def unit(d):
        return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)

    kp0 = torch.cat([x0_in, draws["out0"] * size], 1)
    kp1 = torch.cat([x1_in, draws["out1"] * size], 1)
    return {"descriptors0": unit(d0), "descriptors1": unit(d1),
            "norm_keypoints0": (kp0 - size / 2 - 0.5) / (size.max() * 0.7),
            "norm_keypoints1": (kp1 - size / 2 - 0.5) / (size.max() * 0.7),
            "scores0": draws["s0"], "scores1": draws["s1"]}


def make_pool(mix: dict, dim: int, generator, device) -> list[dict]:
    """`pool` batches of `pairs` pairs, each a feed of device tensors with
    valid0/valid1 [B, slots] bool (a valid prefix of each image's slots)."""
    b, n, pool = mix["pairs"], mix["slots"], mix["pool"]
    low, high = mix["valid"]
    if int(n * mix["inlier_frac"]) > low or high > n:
        raise ValueError(f"scene_pairs: valid counts {mix['valid']} must hold the inliers and fit {n} slots")
    counts = spread_counts(generator, low, high, 2 * b * pool, device).view(pool, 2, b)
    slots = torch.arange(n, device=device)
    out = []
    for i in range(pool):
        draws = draw_scene(generator, b, n, dim, mix["inlier_frac"], mix["image_size"], device)
        feed = feed_from_draws(draws, mix["image_size"], mix["desc_noise"], mix["pixel_noise"])
        for k in ("descriptors0", "descriptors1"):
            feed[k] = feed[k] * mix["desc_scale"]
        feed["valid0"] = slots[None] < counts[i, 0][:, None]
        feed["valid1"] = slots[None] < counts[i, 1][:, None]
        out.append(feed)
    return out
