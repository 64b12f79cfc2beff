"""Matching losses on the dustbin-augmented assignment matrix
(impx/models/loss.py): the NLL of the ground-truth correspondences and of
the dustbin row and column for unmatched keypoints, the optional
hard-negative margin loss, the geometric (epipolar) loss of `with_geo`, and
the match counters. Masked sums over fixed shapes, as in impx.

Data parallelism. impx's sharded step is one program over the global batch,
whose loss averages over pairs and divides by counts of the whole batch
(`num_incorr` > 0 pairs, `any1`). A rank of the port's data-parallel step
holds a block of that batch; given `counts` from `loss_counts` (the global
pair count and counts of pairs with unmatched keypoints, all-reduced once
and without gradient), each function returns this rank's share: the part of
the global value that its pairs contribute, so that the sum of the shares
over the ranks, and the sum of their gradients, are the global ones.
"""
from __future__ import annotations

import torch

from impx_torch.geometry.epipolar import normalize_by_intrinsics, pairwise_epipolar_distance

LOG_EPS = 1e-8  # impx/models/loss.py:12


def _unmatched_rows_cols(gt: torch.Tensor):
    """Per pair: whether any keypoint of image 0 (m1) and of image 1 (m2) is
    unmatched, and those counts."""
    num_incorr1 = gt[:, :, -1].sum(dim=1)
    num_incorr2 = gt[:, -1, :].sum(dim=1)
    return num_incorr1, num_incorr2, num_incorr1 > 0, num_incorr2 > 0


def loss_counts(gt_matching_mask: torch.Tensor, group) -> torch.Tensor | None:
    """The global counts a rank's loss share is normalised by: [pairs, pairs
    with an unmatched keypoint in image 0, in image 1] summed over `group`
    (one all-reduce, no gradient); None without a group."""
    if group is None:
        return None
    from impx_torch.parallel.collectives import psum

    with torch.no_grad():
        _, _, m1, m2 = _unmatched_rows_cols(gt_matching_mask.float())
        local = torch.stack([m1.new_full((), gt_matching_mask.shape[0], dtype=torch.float32),
                             m1.sum().float(), m2.sum().float()])
        return psum(local, group)


def graph_loss(pred_scores: torch.Tensor, gt_matching_mask: torch.Tensor,
               with_hard_negative: bool = False, neg_margin: float = 0.1,
               scores_are_log: bool = False, counts: torch.Tensor | None = None) -> dict:
    """dict(corr=, incorr=, neg=) of scalar losses (impx/models/loss.py:15):
    pred_scores and gt_matching_mask [B, N+1, M+1]. scores_are_log: the
    scores are a log plan (the log-domain head), used as log p directly and
    exponentiated only for the hard-negative term. counts (`loss_counts`):
    this rank's share of the loss of the data-parallel global batch."""
    if scores_are_log:
        log_p = pred_scores
        if with_hard_negative:
            pred_scores = torch.exp(pred_scores)
    else:
        log_p = torch.log(torch.abs(pred_scores) + LOG_EPS)
    gt = gt_matching_mask.to(pred_scores.dtype)

    num_corr = gt[:, :-1, :-1].sum(dim=(1, 2))
    num_corr = torch.where(num_corr == 0, 1.0, num_corr)
    per_pair = (log_p[:, :-1, :-1] * gt[:, :-1, :-1]).sum(dim=(1, 2)) / num_corr

    num_incorr1, num_incorr2, m1, m2 = _unmatched_rows_cols(gt)
    l1 = (log_p[:, :, -1] * gt[:, :, -1]).sum(dim=1)
    l2 = (log_p[:, -1, :] * gt[:, -1, :]).sum(dim=1)
    sum1 = torch.where(m1, l1 / torch.where(m1, num_incorr1, 1.0), 0.0).sum()
    sum2 = torch.where(m2, l2 / torch.where(m2, num_incorr2, 1.0), 0.0).sum()
    if counts is None:
        loss_corr = -per_pair.mean()
        mean1 = sum1 / m1.sum().clamp_min(1)
        mean2 = sum2 / m2.sum().clamp_min(1)
        loss_incorr = torch.where(m1.any(), -(mean1 + mean2) / 2.0, 0.0)
    else:
        loss_corr = -per_pair.sum() / counts[0]
        mean1 = sum1 / counts[1].clamp_min(1)
        mean2 = sum2 / counts[2].clamp_min(1)
        loss_incorr = torch.where(counts[1] > 0, -(mean1 + mean2) / 2.0, 0.0)

    if with_hard_negative:
        loss_neg = hard_negative_loss(pred_scores, gt, neg_margin,
                                      n_pairs=None if counts is None else counts[0])
    else:
        loss_neg = torch.zeros((), dtype=pred_scores.dtype, device=pred_scores.device)
    return {"corr": loss_corr, "incorr": loss_incorr, "neg": loss_neg}


def hard_negative_loss(pred_scores: torch.Tensor, gt: torch.Tensor, neg_margin: float = 0.1,
                       n_pairs: torch.Tensor | None = None):
    """Margin between the best true and the best false assignment of each row
    and column (impx/models/loss.py:57); n_pairs: the global batch's pair
    count, for a data-parallel share."""
    gt_inv = 1.0 - gt
    pos_row = (pred_scores[:, :-1, :] * gt[:, :-1, :]).amax(dim=2)
    pos_col = (pred_scores[:, :, :-1] * gt[:, :, :-1]).amax(dim=1)
    neg_row = (pred_scores[:, :-1, :] * gt_inv[:, :-1, :]).amax(dim=2)
    neg_col = (pred_scores[:, :, :-1] * gt_inv[:, :, :-1]).amax(dim=1)
    mean = (lambda x: x.mean()) if n_pairs is None else (lambda x: x.sum() / (n_pairs * x.shape[1]))
    loss_neg_row = -mean(torch.clamp_max(pos_row - neg_row - neg_margin, 0.0))
    loss_neg_col = -mean(torch.clamp_max(pos_col - neg_col - neg_margin, 0.0))
    return (loss_neg_row + loss_neg_col) / 2.0


def epipolar_loss(pred_scores: torch.Tensor, epipolar_error: torch.Tensor) -> torch.Tensor:
    """Score-weighted epipolar error, a mean over every cell
    (impx/models/loss.py:70)."""
    return torch.mean(pred_scores * epipolar_error)


def geo_loss(pred_scores: torch.Tensor, epi: torch.Tensor, valid0=None, valid1=None,
             n_pairs: torch.Tensor | None = None) -> torch.Tensor:
    """The pose-consistency loss of `with_geo` (impx/models/loss.py:75): the
    epipolar error of the assigned probability mass, sum(p * epi) / sum(p)
    over the valid cells off the dustbin, a mean over the batch.
    pred_scores [B, N+1, M+1] (a plan, not a log plan); epi [B, N, M],
    clamped by the caller; valid0/valid1 [B, N] / [B, M] bool; n_pairs: the
    global batch's pair count, for a data-parallel share."""
    p = pred_scores[:, :-1, :-1]
    if valid0 is not None:
        p = p * (valid0[:, :, None] & valid1[:, None, :]).to(p.dtype)
    mass = p.sum(dim=(1, 2))
    per_pair = (p * epi).sum(dim=(1, 2)) / torch.clamp_min(mass, 1e-6)
    return torch.mean(per_pair) if n_pairs is None else per_pair.sum() / n_pairs


def maybe_epipolar_matrix(data: dict, clamp: float):
    """The clamped all-pairs epipolar error [B, N, M] of a training batch
    (impx/models/loss.py:101), or None when the batch lacks pixel keypoints,
    intrinsics or gt_E (the MegaDepth layout has them)."""
    needed = ("keypoints0", "keypoints1", "intrinsics0", "intrinsics1", "gt_E")
    if not all(k in data for k in needed):
        return None
    x0n = normalize_by_intrinsics(data["keypoints0"], data["intrinsics0"])
    x1n = normalize_by_intrinsics(data["keypoints1"], data["intrinsics1"])
    return torch.clamp_max(pairwise_epipolar_distance(x0n, x1n, data["gt_E"]), clamp)


def matching_accuracy(indices0: torch.Tensor, gt_matching_mask: torch.Tensor, n_iters: int = 1,
                      n_pairs=None) -> dict:
    """Correct and incorrect match counters (impx/models/loss.py:119):
    indices0 [B, N] (-1 unmatched), gt mask [B, N+1, M+1]; fp32 scalars.
    n_pairs: the global batch's pair count (a data-parallel share)."""
    b = indices0.shape[0] if n_pairs is None else n_pairs
    gt_matches = gt_matching_mask[:, :-1, :].argmax(dim=-1)  # first index of the max
    dust = gt_matching_mask.shape[-1] - 1
    denom = b * n_iters
    count = lambda x: x.sum().float() / denom
    return {
        "acc_corr": count((indices0 == gt_matches) & (indices0 != -1) & (gt_matches < dust)),
        "acc_incorr": count((indices0 == -1) & (gt_matches == dust)),
        "total_acc_corr": count(gt_matches < dust),
        "total_acc_incorr": count(gt_matches == dust),
    }
