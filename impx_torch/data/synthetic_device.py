"""Matchable two-view scenes generated on the device
(impx/data/synthetic_device.py): the distribution and conventions of
`synthesize_pair` (pose, pinhole projection, correlated descriptors), drawn
as whole batches on the card so that a benchmark sees fresh geometry every
call without a host upload.

Shapes are fixed: no visibility rejection. 3D points lie in the central
frustum of camera 0 with a modest baseline, so most reprojections land in
the image; those that do not are harmless (neither the matcher nor RANSAC
assumes in-bounds coordinates).

The draws and the construction are two functions: `draw_scene` takes every
random array from one torch.Generator, `feed_from_draws` builds the feed
from them. impx draws from twelve split threefry keys, which torch cannot
reproduce; given impx's arrays, `feed_from_draws` gives impx's feed.
"""
from __future__ import annotations

import torch

from impx_torch.device import resolve_device

# the draws, in the order of impx's twelve split keys (ks[0] is the rotation's
# axis and angle, ks[10] the four descriptor noises, ks[11] the two scores)
DRAW_KEYS = ("axis", "angle_deg", "t", "z", "xp", "yp", "noise0", "noise1", "out0", "out1",
             "shared", "noise_d0", "noise_d1", "d0_out", "d1_out", "s0", "s1")


def rotation_from_axis_angle(axis: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Batched Rodrigues rotation [B, 3, 3] about axis [B, 3] (normalised
    here) by angle_deg [B] degrees."""
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


def draw_scene(generator: torch.Generator, batch: int, n_kpts: int, dim: int, inlier_frac: float = 0.25,
               image_size=(480, 640), device: torch.device | None = None) -> dict[str, torch.Tensor]:
    """Every random array of a batch of scenes (DRAW_KEYS), on the
    generator's device: the rotation's axis and angle (5 to 60 degrees),
    the translation, depths in [4, 12), the inliers' pixels in the central
    60% of the image, the pixel noises, the outliers' positions in [0, 1),
    the shared descriptors and their noises, the outliers' descriptors and
    the scores in [0.1, 1)."""
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


def feed_from_draws(draws: dict[str, torch.Tensor], image_size=(480, 640), desc_noise: float = 0.15,
                    pixel_noise: float = 0.5):
    """The feed, the ground-truth rotation and translation of `draw_scene`'s
    arrays (impx/data/synthetic_device.py:47-113): the inliers first, then
    the outliers, in each image. Returns (feed, R [B, 3, 3], t [B, 3])."""
    h, w = image_size
    f = 0.9 * max(h, w)
    cx, cy = w / 2.0, h / 2.0
    dev = draws["t"].device
    R = rotation_from_axis_angle(draws["axis"], draws["angle_deg"])
    t = draws["t"] / (torch.linalg.norm(draws["t"], dim=-1, keepdim=True) + 1e-12)

    z, xp, yp = draws["z"], draws["xp"], draws["yp"]
    X = torch.stack([(xp - cx) / f * z, (yp - cy) / f * z, z], -1)      # [B, n_in, 3]
    baseline = 0.3 * z.mean(dim=1)   # NaN without inliers, as in impx; nothing reads it then
    X1 = torch.einsum("bnk,bjk->bnj", X, R) + (t * baseline[:, None])[:, None, :]
    centre = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    u1 = X1[..., :2] / torch.clamp(X1[..., 2:3], min=0.1) * f + centre

    x0_in = torch.stack([xp, yp], -1) + pixel_noise * draws["noise0"]
    x1_in = u1 + pixel_noise * draws["noise1"]
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    x0_out = draws["out0"] * size
    x1_out = draws["out1"] * size

    shared = draws["shared"]
    d0 = torch.cat([shared + desc_noise * draws["noise_d0"], draws["d0_out"]], 1)
    d1 = torch.cat([shared + desc_noise * draws["noise_d1"], draws["d1_out"]], 1)

    def unit(d):
        return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)

    kp0 = torch.cat([x0_in, x0_out], 1)
    kp1 = torch.cat([x1_in, x1_out], 1)
    valid = torch.ones(draws["s0"].shape, dtype=torch.bool, device=dev)
    feed = {
        "descriptors0": unit(d0), "descriptors1": unit(d1),
        "norm_keypoints0": (kp0 - size / 2 - 0.5) / (size.max() * 0.7),
        "norm_keypoints1": (kp1 - size / 2 - 0.5) / (size.max() * 0.7),
        "scores0": draws["s0"], "scores1": draws["s1"],
        "valid0": valid, "valid1": valid.clone(),
        "x0n": (kp0 - centre) / f,
        "x1n": (kp1 - centre) / f,
    }
    return feed, R, t


def synthesize_feed_device(generator: torch.Generator, batch: int, n_kpts: int, dim: int,
                           inlier_frac: float = 0.25, image_size=(480, 640), desc_noise: float = 0.15,
                           pixel_noise: float = 0.5, device: str | torch.device | None = None):
    """A batch of matcher feeds with ground-truth poses, drawn on `device`
    (the CUDA device unless named) from `generator`, a torch.Generator on
    that device. Returns (feed, R, t): feed holds descriptors0/1 [B, N, D]
    (unit norm), norm_keypoints0/1 [B, N, 2], scores0/1 [B, N], valid0/1
    [B, N] (all true), x0n/x1n [B, N, 2] (intrinsics-normalised); R
    [B, 3, 3] and t [B, 3] the relative pose (E = [t]x R, as in
    synthesize_pair). inlier_frac 0 gives pairs with no true
    correspondence."""
    device = resolve_device(device)
    draws = draw_scene(generator, batch, n_kpts, dim, inlier_frac, image_size, device)
    return feed_from_draws(draws, image_size, desc_noise, pixel_noise)
