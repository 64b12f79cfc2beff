"""GM — the base graph matcher's building blocks (impx/models/gm.py).

Keypoint encoding, the per-iteration final projection and scaled dot-product
distance, the score head (non-log Sinkhorn, or the log-domain optimal
transport under config.log_ot) and mutual-NN matches. The forwards that
string them together are DGNNS's (impx_torch/models/dgnns.py, through
impx_torch/models/fast.py) and SuperGlue's (impx_torch/models/superglue.py);
the unrolled non-sharing GM forward is not ported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from impx_torch.device import resolve_device
from impx_torch.geometry.keypoints import normalize_keypoints
from impx_torch.models.config import MatcherConfig
from impx_torch.models.gnn import MLP, AttentionalPropagation, Dense
from impx_torch.ops.kernels.log_sinkhorn import log_optimal_transport_fused
from impx_torch.ops.matching import compute_matches as _compute_matches
from impx_torch.ops.sinkhorn import sink_algorithm


class GM(nn.Module):
    """Base matcher with random weights drawn from `seed`; load trained or
    carried-across weights with `load_state_dict` (impx_torch/tools/convert.py).

    device: the CUDA device unless named; raises without one.
    use_kernels: False runs the plain PyTorch versions of the kernels on any
    device (the reference the kernels are held against). On CPU tensors the
    kernel wrappers run those plain versions anyway."""

    sharing = False

    def __init__(self, config: MatcherConfig, device: str | torch.device | None = None,
                 seed: int = 0, use_kernels: bool = True):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.compute_dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
        self.use_kernels = use_kernels
        d = config.descriptor_dim
        self.kenc = MLP([3, *config.keypoint_encoder, d], config.norm_fn)
        self.gnn = nn.ModuleList(
            AttentionalPropagation(d, config.num_heads, shared, config.norm_fn)
            for shared in config.sharing_layers(self.sharing))
        self.final_proj = nn.ModuleList(Dense(d, d) for _ in range(config.n_layers))
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(self.device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kenc.reset_parameters(generator)
        for layer in self.gnn:
            layer.reset_parameters(generator)
        for p in self.final_proj:
            p.reset_parameters(generator)
        self.bin_score.fill_(1.0)

    def _on_device(self, data: dict[str, Any]) -> dict[str, Any]:
        """Arrays and tensors of `data` moved to the model's device, floating
        point as fp32 (numpy's float64 included, as impx's jnp arrays are)."""
        out = {}
        for k, v in data.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                v = torch.as_tensor(v, device=self.device)
                if v.is_floating_point():
                    v = v.float()
            out[k] = v
        return out

    # ------------------------------------------------------------- building blocks
    def encode_keypoint(self, norm_kpts, scores, valid=None):
        """MLP over (x, y, score) -> [B, N, D] (impx/models/gm.py:58)."""
        x = torch.cat([norm_kpts, scores[..., None]], dim=-1)
        return self.kenc(x, ac_fn=self.config.ac_fn, mask=valid)

    def _norm_kpts(self, data, which: int):
        key = f"norm_keypoints{which}"
        if key in data:
            return data[key]
        shape = data[f"image_shape{which}"]  # (..., H, W)
        return normalize_keypoints(data[f"keypoints{which}"], shape[-2], shape[-1])

    def compute_distance(self, desc0, desc1, layer_id: int = -1):
        """Final projection + scaled dot product (impx/models/gm.py:74)."""
        p = self.final_proj[layer_id]
        dist = torch.einsum("bnd,bmd->bnm", p(desc0), p(desc1))
        return dist / (self.config.descriptor_dim ** 0.5)

    @property
    def scores_are_log(self) -> bool:
        """True when compute_score returns a log transport plan (the
        log-domain head; SuperGlue's always)."""
        return self.config.log_ot

    def compute_score(self, dist, valid0=None, valid1=None):
        """The score head with the learned dustbin (impx/models/gm.py:88). The
        log-domain head follows impx's attn_impl='pallas' path: u and v from
        the log-Sinkhorn kernel (its plain version when use_kernels is False),
        then the fp32 log plan. Otherwise the non-log Sinkhorn plan."""
        if self.scores_are_log:
            return log_optimal_transport_fused(dist, self.bin_score, self.config.sinkhorn_iterations,
                                               valid0, valid1, plain=not self.use_kernels)
        plan_dtype = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
        return sink_algorithm(dist, self.bin_score, self.config.sinkhorn_iterations,
                              valid0, valid1, plan_dtype=plan_dtype)

    def compute_matches(self, scores, p=0.2, valid0=None, valid1=None):
        """Mutual-NN matches of a plan; a log plan is exponentiated first
        (impx/models/gm.py:114-117)."""
        if self.scores_are_log:
            scores = torch.exp(scores)
        return _compute_matches(scores, p=p, valid0=valid0, valid1=valid1)
