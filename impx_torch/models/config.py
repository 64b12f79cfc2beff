"""Typed matcher configuration (a copy of impx/models/config.py:MatcherConfig).

The port keeps its own copy because importing `impx.models.config` runs
`impx/models/__init__.py`, which imports jax.

Left out of the copy:
  * `attn_impl` and `attn_block_q`: the port picks the attention by device (the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors), and the
    kernel chooses its own tiles;
  * the log-domain head (`log_ot`), the dual-softmax switch (`with_sinkhorn`)
    and the training fields (`train_*`, `with_geo`, `geo_*`): they arrive with
    the slices that port those paths.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    descriptor_dim: int = 256
    keypoint_encoder: Sequence[int] = (32, 64, 128, 256)
    n_layers: int = 9  # self+cross iterations
    num_heads: int = 4
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    ac_fn: str = "relu"
    # only 'in' (masked InstanceNorm, the published eval config) is ported;
    # batch norm arrives with training
    norm_fn: str = "bn"
    # EIMP (AdaGMN): pooling never shrinks an image below n_min_tokens kept
    # keypoints, and starts at iteration first_it_to_update
    n_min_tokens: int = 256
    first_it_to_update: int = 2
    # EIMP bucketed compaction: ((iteration, bucket), ...); before
    # `iteration`, gather both images' kept keypoints into `bucket` slots.
    # Empty = mask-only pooling.
    compaction: tuple = ()
    # activation stream dtype ('float32' | 'bfloat16'); InstanceNorm
    # statistics, the final projection and the Sinkhorn head stay fp32
    compute_dtype: str = "float32"

    def sharing_layers(self, share: bool) -> list[bool]:
        """DGNNS attention-sharing pattern: the first two iterations fully
        recompute, then (recompute, recompute, share, share) per pair of
        iterations. Index 2i is iteration i's self layer, 2i+1 its cross layer."""
        if not share:
            return [False] * (2 * self.n_layers)
        pattern = [False, False] * 2 + [False, False, True, True] * 21
        return pattern[: 2 * self.n_layers]

    @classmethod
    def eval_config(cls, feature: str = "spp", n_layers: int = 15) -> "MatcherConfig":
        """The published eval configuration (impx/models/config.py:113)."""
        return cls(
            descriptor_dim=256 if feature == "spp" else 128,
            n_layers=n_layers,
            sinkhorn_iterations=20,
            match_threshold=0.2,
            ac_fn="relu",
            norm_fn="in",
            n_min_tokens=256,
        )
