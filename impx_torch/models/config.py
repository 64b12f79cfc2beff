"""Typed matcher configuration (a copy of impx/models/config.py:MatcherConfig).

The port keeps its own copy because importing `impx.models.config` runs
`impx/models/__init__.py`, which imports jax.

Left out of the copy:
  * `attn_impl` and `attn_block_q`: the port picks the attention by device (the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors), and the
    kernel chooses its own tiles;
  * `train_remat`: it chooses only what XLA stores for the backward (its
    values are identical under every policy, tests/test_fast_train.py:44);
    eager autograd stores every activation.
A config that names a field left out is refused with a TypeError, as for any
unknown field.

`log_ot` (the log-domain optimal-transport head) and `with_sinkhorn=False`
(the dual-softmax head) hold at inference and in training; SuperGlue runs
the log-domain head whatever the field says.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

TRAIN_SUPERVISION = ("all", "last")


def compaction_schedule(spec, n_layers: int, name: str = "compaction", n: int | None = None) -> list:
    """A compaction schedule ((iteration, bucket), ...) sorted by iteration,
    checked as impx checks it (impx/models/fast.py:1153-1161): iterations
    distinct and in (0, n_layers), and, given the keypoint count n, buckets
    that never grow from n on. Raises ValueError naming `name`."""
    schedule = sorted((int(it), int(k)) for it, k in spec)
    its = [it for it, _ in schedule]
    if not all(0 < it < n_layers for it in its) or len(set(its)) != len(its):
        raise ValueError(f"{name} iterations must be distinct, in (0, n_layers={n_layers}): {schedule}")
    buckets = ([] if n is None else [n]) + [k for _, k in schedule]
    if any(a < b for a, b in zip(buckets, buckets[1:])):
        raise ValueError(f"{name} buckets must not grow: {buckets}")
    return schedule


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    descriptor_dim: int = 256
    keypoint_encoder: Sequence[int] = (32, 64, 128, 256)
    n_layers: int = 9  # self+cross iterations
    num_heads: int = 4
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    # score head: True is the dustbin Sinkhorn; False the dual softmax
    # (impx/ops/sinkhorn.py:dual_softmax), unless log_ot is set
    with_sinkhorn: bool = True
    ac_fn: str = "relu"
    # 'in' (masked InstanceNorm, the published IMP/EIMP eval and training
    # configs) or 'bn' (batch norm: from running statistics at inference;
    # in training GM, DGNNS and SuperGlue take the keypoint encoder's from
    # the batch, AdaGMN every MLP's, as impx's trainers do)
    norm_fn: str = "bn"
    # EIMP (AdaGMN): pooling never shrinks an image below n_min_tokens kept
    # keypoints, and starts at iteration first_it_to_update
    n_min_tokens: int = 256
    first_it_to_update: int = 2
    # EIMP bucketed compaction: ((iteration, bucket), ...); before
    # `iteration`, gather both images' kept keypoints into `bucket` slots.
    # Empty = mask-only pooling.
    compaction: tuple = ()
    # EIMP training compaction (impx/models/config.py:34-45): the same
    # ((iteration, bucket), ...) schedule on the training scan
    # (models/fast.py:forward_train_scan_eimp_compact). The ground-truth mask
    # and the epipolar matrix are gathered with the keypoints, the loss runs
    # on the compacted plan, and matches and accuracy go back to the original
    # indexing. Dropping tokens is the sliced semantics, not the masked
    # trainer's (discarded keypoints stay queries and in the norm statistics
    # there): a cheaper, different objective, whose survivors beyond a
    # bucket are counted (compaction_overflow0/1). Empty = the masked trainer.
    train_compaction: tuple = ()
    # activation stream dtype ('float32' | 'bfloat16'); InstanceNorm
    # statistics, the final projection and the Sinkhorn head stay fp32
    compute_dtype: str = "float32"
    # score head: False is the non-log Sinkhorn, True the log-domain optimal
    # transport (impx/ops/sinkhorn.py:log_optimal_transport; the kernel of
    # impx/ops/pallas/log_sinkhorn.py on the card)
    log_ot: bool = False
    # training (models/fast.py:forward_train_scan). train_fused: route B, the
    # attention core whose forward saves the row log-sum-exp and whose
    # backward runs from it (impx/models/fast.py:_make_fused_layer); False is
    # route A, the forward kernel and the backward that recomputes the
    # softmax. train_supervision: 'all' puts a Sinkhorn head and a loss on
    # every iteration (the reference objective), 'last' on the last only.
    train_fused: bool = False
    train_supervision: str = "all"
    # geometry-supervised training: with_geo adds geo_weight times the
    # epipolar error of the assigned mass under the ground-truth pose
    # (models/loss.py:geo_loss), the all-pairs error clamped at geo_clamp
    with_geo: bool = False
    geo_weight: float = 50.0
    geo_clamp: float = 0.05

    def __post_init__(self):
        if self.train_supervision not in TRAIN_SUPERVISION:
            raise ValueError(f"unknown train_supervision {self.train_supervision!r} "
                             f"(expected one of {TRAIN_SUPERVISION})")
        if self.train_compaction:
            compaction_schedule(self.train_compaction, self.n_layers, "train_compaction")

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
