"""SuperPoint detector and descriptor (impx/models/superpoint.py).

The VGG-style shared encoder (8 convs, 3 max-pools), the 65-channel score
head reshaped from 8x8 cells to pixels, the iterated max-pool NMS, border
removal, a fixed K = max_keypoints slots with a validity mask (score >
keypoint_threshold), and bilinear descriptor sampling at the keypoints.

Layout: OIHW weights, the reference superpoint_v1.pth's own layout, so its
state_dict loads as it is (`conv1a.weight`, ...); NCHW images and outputs,
the bf16 activations channels-last inside the encoder. The
convolutions run in cuDNN and the rest in plain PyTorch: impx runs them as
XLA ops, not as Pallas kernels.

Arithmetic against impx:
  * fp32: every conv runs with cuDNN's TF32 off (`torch.backends.cudnn.flags`
    around the convs only; the process's flag is left as it is), so a conv
    on the card is an IEEE fp32 conv, as impx's is;
  * bf16: the activations and weights are bf16; impx accumulates each conv in
    fp32 and rounds once after the bias, while F.conv2d rounds its bf16 output
    before the bias is added in fp32, so bf16 agrees within a stated tolerance;
    the score softmax and the descriptor norm run in fp32 in both dtypes;
  * the top-K selection equals jax.lax.top_k's, ties included (lowest index
    first): scores are >= 0, so their float bits order as int32, and a
    composite int64 key (bits << 32 | reversed index) makes every key unique;
  * descriptor sampling copies impx's align_corners=False arithmetic with
    indices clipped to the grid (edge replicate), not F.grid_sample's zero
    padding, which differs within half a cell of the border.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from impx_torch.device import resolve_device

DEFAULT_CONFIG = {
    "descriptor_dim": 256,
    "nms_radius": 4,
    "keypoint_threshold": 0.0025,
    "max_keypoints": 1024,
    "remove_borders": 4,
}

# name -> (kernel size, in channels, out channels); the last one's out is the descriptor dim
CONV_PLAN = {
    "conv1a": (3, 1, 64), "conv1b": (3, 64, 64),
    "conv2a": (3, 64, 64), "conv2b": (3, 64, 64),
    "conv3a": (3, 64, 128), "conv3b": (3, 128, 128),
    "conv4a": (3, 128, 128), "conv4b": (3, 128, 128),
    "convPa": (3, 128, 256), "convPb": (1, 256, 65),
    "convDa": (3, 128, 256), "convDb": (1, 256, None),
}


@contextlib.contextmanager
def ieee_fp32_convs():
    """cuDNN's TF32 off for the convs inside, every other cuDNN flag as it is."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _conv(params: Mapping[str, torch.Tensor], name: str, x: torch.Tensor,
          memory_format: torch.memory_format = torch.contiguous_format) -> torch.Tensor:
    """conv + bias in x's dtype and layout: the bias is added in fp32 and the
    sum rounded once to x's dtype, in place, in one pass (torch.add computes
    in the promoted fp32 and casts on the store: (y.float() + b).to(x.dtype))."""
    w = params[f"{name}.weight"]
    y = F.conv2d(x, w.to(x.dtype, memory_format=memory_format), padding=w.shape[-1] // 2)   # SAME, odd kernels
    return torch.add(y, params[f"{name}.bias"].float()[:, None, None], out=y)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 SAME pool with -inf padding: an odd size's last window
    holds one row or column, as ceil_mode's."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Iterated max-pool NMS (impx/models/superpoint.py:47). scores [B, H, W]."""
    def max_pool(x):
        return F.max_pool2d(x[:, None], nms_radius * 2 + 1, 1, padding=nms_radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


@torch.no_grad()
def backbone(params: Mapping[str, torch.Tensor], image: torch.Tensor,
             compute_dtype: torch.dtype = torch.float32):
    """image [B, 1, H, W] in [0, 1] -> (dense scores [B, 8h, 8w] fp32,
    descriptors [B, D, h, w] fp32, L2-normalised over D), h = ceil(H / 8).
    params: the reference state_dict layout (`conv1a.weight` OIHW, ...).
    Inference only (the convs' bias is added in place)."""
    fp32 = compute_dtype == torch.float32
    # bf16 runs channels-last, which cuDNN's NHWC kernels take without layout passes, fp32 NCHW,
    # which its fp32 kernels run faster (impx_torch/tools/superpoint_phases.py; PERF.md section 5)
    fmt = torch.contiguous_format if fp32 else torch.channels_last
    conv = functools.partial(_conv, params, memory_format=fmt)
    with ieee_fp32_convs() if fp32 else contextlib.nullcontext():
        x = image.to(compute_dtype).contiguous(memory_format=fmt)
        for block in ("1", "2", "3"):
            for name in (f"conv{block}a", f"conv{block}b"):
                x = F.relu(conv(name, x), inplace=True)
            x = _max_pool2(x)
        for name in ("conv4a", "conv4b"):
            x = F.relu(conv(name, x), inplace=True)
        scores = conv("convPb", F.relu(conv("convPa", x), inplace=True)).float()
        desc = conv("convDb", F.relu(conv("convDa", x), inplace=True)).float()
    scores = torch.softmax(scores, dim=1)[:, :-1]                   # [B, 64, h, w]
    b, _, h, w = scores.shape
    # channel 8 i + j is pixel (8 y + i, 8 x + j) of cell (y, x)
    scores = scores.reshape(b, 8, 8, h, w).permute(0, 3, 1, 4, 2).reshape(b, h * 8, w * 8)
    desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-15)
    return scores, desc


def sample_descriptors(keypoints: torch.Tensor, descriptors: torch.Tensor, s: int = 8) -> torch.Tensor:
    """Bilinear descriptor sampling at pixel keypoints with align_corners=False
    and edge-replicate indices (impx/models/superpoint.py:94).
    keypoints [B, K, 2] (x, y) pixels; descriptors [B, D, hc, wc].
    Returns [B, K, D], L2-normalised."""
    b, d, hc, wc = descriptors.shape
    kp = keypoints - s / 2 + 0.5
    kp = kp / torch.tensor([(wc * s - s / 2 - 0.5), (hc * s - s / 2 - 0.5)],
                           dtype=keypoints.dtype, device=keypoints.device)
    kp = kp * 2 - 1
    gx = ((kp[..., 0] + 1.0) * wc - 1.0) / 2.0
    gy = ((kp[..., 1] + 1.0) * hc - 1.0) / 2.0

    x0 = torch.floor(gx).to(torch.int64).clamp(0, wc - 1)
    y0 = torch.floor(gy).to(torch.int64).clamp(0, hc - 1)
    x1 = (x0 + 1).clamp(0, wc - 1)
    y1 = (y0 + 1).clamp(0, hc - 1)
    wx = (gx - x0).clamp(0.0, 1.0)[..., None]
    wy = (gy - y0).clamp(0.0, 1.0)[..., None]

    grid = descriptors.flatten(2).transpose(1, 2)                    # [B, hc * wc, D]

    def at(y, x):
        return torch.gather(grid, 1, (y * wc + x)[..., None].expand(-1, -1, d))

    out = (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy)
           + at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy)
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-15)


def top_k(flat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k of a [B, N] tensor of scores >= 0: the k largest in
    descending order, equal scores by ascending index. Returns (values,
    indices int64)."""
    n = flat.shape[1]
    bits = flat.float().contiguous().view(torch.int32).to(torch.int64)
    rank = n - 1 - torch.arange(n, device=flat.device)
    _, key_idx = torch.topk((bits << 32) | rank, k, dim=1)
    return torch.gather(flat, 1, key_idx), key_idx


@torch.no_grad()
def extract_keypoints(params: Mapping[str, torch.Tensor], image: torch.Tensor, nms_radius: int = 4,
                      max_keypoints: int = 1024, border: int = 4, keypoint_threshold: float = 0.0025,
                      compute_dtype: torch.dtype = torch.float32) -> dict:
    """image [B, 1, H, W] -> dict(keypoints [B, K, 2] (x, y) fp32, scores
    [B, K], descriptors [B, K, D], valid [B, K]), K = max_keypoints
    (impx/models/superpoint.py:127)."""
    scores, dense_desc = backbone(params, image, compute_dtype)
    scores = simple_nms(scores, nms_radius)
    b, h, w = scores.shape
    ys = torch.arange(h, device=scores.device)[:, None]
    xs = torch.arange(w, device=scores.device)[None, :]
    border_ok = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    scores = torch.where(border_ok[None], scores, torch.zeros((), device=scores.device))

    top_scores, top_idx = top_k(scores.reshape(b, h * w), max_keypoints)
    keypoints = torch.stack([(top_idx % w).float(), (top_idx // w).float()], dim=-1)
    valid = top_scores > keypoint_threshold
    return {
        "keypoints": keypoints,
        "scores": torch.where(valid, top_scores, torch.zeros((), device=scores.device)),
        "descriptors": sample_descriptors(keypoints, dense_desc),
        "valid": valid,
    }


class SuperPoint(nn.Module):
    """SuperPoint with the reference's parameter names (conv1a ... convDb as
    nn.Conv2d, OIHW), on the CUDA device unless `device` is named. Random
    weights from `seed` (impx's init_params channel plan and He-normal scale,
    zero biases) until the reference weights are loaded."""

    def __init__(self, config: dict | None = None, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        self.config = {**DEFAULT_CONFIG, **(config or {})}
        self.device = resolve_device(device)
        for name, (ks, cin, cout) in CONV_PLAN.items():
            cout = self.config["descriptor_dim"] if cout is None else cout
            self.add_module(name, nn.Conv2d(cin, cout, ks, padding=ks // 2))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in CONV_PLAN:
            conv = getattr(self, name)
            ks, cin = conv.kernel_size[0], conv.in_channels
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * (2.0 / (ks * ks * cin)) ** 0.5)
            conv.bias.zero_()

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def _image(self, image) -> torch.Tensor:
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        return image[:, None] if image.dim() == 3 else image

    @torch.no_grad()
    def backbone(self, image, compute_dtype: torch.dtype = torch.float32):
        """image [B, H, W] or [B, 1, H, W] in [0, 1] -> (dense scores, descriptors)."""
        return backbone(self.params(), self._image(image), compute_dtype)

    @torch.no_grad()
    def forward(self, image, compute_dtype: torch.dtype = torch.float32, **overrides) -> dict:
        """image [B, H, W] or [B, 1, H, W] in [0, 1] -> extract_keypoints'
        dict at this model's config (overrides: nms_radius, max_keypoints,
        remove_borders, keypoint_threshold)."""
        c = {**self.config, **overrides}
        return extract_keypoints(self.params(), self._image(image), nms_radius=c["nms_radius"],
                                 max_keypoints=c["max_keypoints"], border=c["remove_borders"],
                                 keypoint_threshold=c["keypoint_threshold"], compute_dtype=compute_dtype)


def compare_extractions(a: dict, b: dict, margin: float, nms_radius: int = 4) -> dict:
    """impx's margin rule for two extractions of one image (the first of each
    batch) whose dense score maps differ by at most `margin`
    (tests/test_superpoint.py::test_bf16_extraction_agrees_with_fp32). Returns the overlap |A & B| /
    |A | B| of the two valid keypoint sets, the keypoints of either set that
    the rule does not explain, and the smallest descriptor cosine over the
    shared keypoints. A keypoint in one set only is explained when its score
    lies below the other set's cutoff (its smallest valid score) plus
    2 margin, or when the other set holds a keypoint within nms_radius in x
    and in y (an NMS winner moved by a flip at the last bit)."""
    def side(out):
        valid = out["valid"][0].cpu().numpy()
        kp = out["keypoints"][0].cpu().numpy()[valid].astype(int)
        keys = [tuple(k) for k in kp]
        scores = dict(zip(keys, out["scores"][0].cpu().float().numpy()[valid].tolist()))
        descs = dict(zip(keys, out["descriptors"][0].cpu().float().numpy()[valid]))
        return set(keys), scores, descs

    (ka, sa, da), (kb, sb, db) = side(a), side(b)
    union = ka | kb
    overlap = len(ka & kb) / max(len(union), 1)
    cut_a = min(sa.values(), default=0.0)
    cut_b = min(sb.values(), default=0.0)

    def explained(k, score, other, other_cut):
        return score < other_cut + 2 * margin or any(
            abs(k[0] - o[0]) <= nms_radius and abs(k[1] - o[1]) <= nms_radius for o in other)

    unexplained = ([k for k in ka - kb if not explained(k, sa[k], kb, cut_b)]
                   + [k for k in kb - ka if not explained(k, sb[k], ka, cut_a)])
    cosines = [float((da[k] * db[k]).sum()) for k in ka & kb]
    return {"overlap": overlap, "n": (len(ka), len(kb)), "unexplained": unexplained,
            "min_cosine": min(cosines, default=1.0)}
