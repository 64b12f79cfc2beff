"""Matching losses on the dustbin-augmented assignment matrix
(impx/models/loss.py): the NLL of the ground-truth correspondences and of
the dustbin row and column for unmatched keypoints, the optional
hard-negative margin loss, and the match counters. Masked sums over fixed
shapes, as in impx. The log-domain scores (`scores_are_log`) and the
geometric loss wait for the slices that port the log-OT head and `with_geo`.
"""
from __future__ import annotations

import torch

LOG_EPS = 1e-8  # impx/models/loss.py:12


def graph_loss(pred_scores: torch.Tensor, gt_matching_mask: torch.Tensor,
               with_hard_negative: bool = False, neg_margin: float = 0.1) -> dict:
    """dict(corr=, incorr=, neg=) of scalar losses (impx/models/loss.py:15,
    scores_are_log=False): pred_scores and gt_matching_mask [B, N+1, M+1]."""
    log_p = torch.log(torch.abs(pred_scores) + LOG_EPS)
    gt = gt_matching_mask.to(pred_scores.dtype)

    num_corr = gt[:, :-1, :-1].sum(dim=(1, 2))
    num_corr = torch.where(num_corr == 0, 1.0, num_corr)
    loss_corr = -((log_p[:, :-1, :-1] * gt[:, :-1, :-1]).sum(dim=(1, 2)) / num_corr).mean()

    num_incorr1 = gt[:, :, -1].sum(dim=1)
    num_incorr2 = gt[:, -1, :].sum(dim=1)
    l1 = (log_p[:, :, -1] * gt[:, :, -1]).sum(dim=1)
    l2 = (log_p[:, -1, :] * gt[:, -1, :]).sum(dim=1)
    m1, m2 = num_incorr1 > 0, num_incorr2 > 0
    mean1 = torch.where(m1, l1 / torch.where(m1, num_incorr1, 1.0), 0.0).sum() / m1.sum().clamp_min(1)
    mean2 = torch.where(m2, l2 / torch.where(m2, num_incorr2, 1.0), 0.0).sum() / m2.sum().clamp_min(1)
    loss_incorr = torch.where(m1.any(), -(mean1 + mean2) / 2.0, 0.0)

    if with_hard_negative:
        loss_neg = hard_negative_loss(pred_scores, gt, neg_margin)
    else:
        loss_neg = torch.zeros((), dtype=pred_scores.dtype, device=pred_scores.device)
    return {"corr": loss_corr, "incorr": loss_incorr, "neg": loss_neg}


def hard_negative_loss(pred_scores: torch.Tensor, gt: torch.Tensor, neg_margin: float = 0.1):
    """Margin between the best true and the best false assignment of each row
    and column (impx/models/loss.py:57)."""
    gt_inv = 1.0 - gt
    pos_row = (pred_scores[:, :-1, :] * gt[:, :-1, :]).amax(dim=2)
    pos_col = (pred_scores[:, :, :-1] * gt[:, :, :-1]).amax(dim=1)
    neg_row = (pred_scores[:, :-1, :] * gt_inv[:, :-1, :]).amax(dim=2)
    neg_col = (pred_scores[:, :, :-1] * gt_inv[:, :, :-1]).amax(dim=1)
    loss_neg_row = -torch.clamp_max(pos_row - neg_row - neg_margin, 0.0).mean()
    loss_neg_col = -torch.clamp_max(pos_col - neg_col - neg_margin, 0.0).mean()
    return (loss_neg_row + loss_neg_col) / 2.0


def matching_accuracy(indices0: torch.Tensor, gt_matching_mask: torch.Tensor, n_iters: int = 1) -> dict:
    """Correct and incorrect match counters (impx/models/loss.py:119):
    indices0 [B, N] (-1 unmatched), gt mask [B, N+1, M+1]; fp32 scalars."""
    b = indices0.shape[0]
    gt_matches = gt_matching_mask[:, :-1, :].argmax(dim=-1)  # first index of the max
    dust = gt_matching_mask.shape[-1] - 1
    denom = float(b * n_iters)
    count = lambda x: x.sum().float() / denom
    return {
        "acc_corr": count((indices0 == gt_matches) & (indices0 != -1) & (gt_matches < dust)),
        "acc_incorr": count((indices0 == -1) & (gt_matches == dust)),
        "total_acc_corr": count(gt_matches < dust),
        "total_acc_incorr": count(gt_matches == dust),
    }
