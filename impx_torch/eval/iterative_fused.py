"""The lockstep batched iterative loop of impx's single program
(impx/eval/iterative_fused.py): B pairs advance together through the
layers, each freezing its outputs at its own stopping checkpoint, and the
loop stops once every pair has converged.

Its semantics are impx's fused loop's, not those of
impx_torch/eval/iterative.py:BatchedIterativeMatcher:
  * the stream runs in the compute dtype through `model.gnn` (the stacked
    forward's layers), keys and queries under the keep masks;
  * a checkpoint scores through kernel 2's statistics (`sinkhorn_fused_stats`
    and `matches_from_stats` at match_ratio), never building the plan;
  * a pair that never converges keeps its last checkpoint's matches (no
    p = 0.2 fallback);
  * with_uncertainty (AdaGMN) pools the keep masks after each checkpoint
    from kernel 2's row and column masses and kernel 6's masses over the
    carried q/k, at the threshold mscore_base x the pose's inlier ratio.

impx's scan takes an identity branch once every pair has converged; here
the host reads one bool a checkpoint and stops. Nothing else is read back
inside the loop. The RANSAC draws of pair b at iteration it come from
`pair_generator(device, seeds[it], b)`; one seed repeated n_layers times
reuses a pair's draws at every checkpoint (bench_suite.py:283-289).

The pieces shared with the queue loops (impx_torch/eval/iterative_refill.py,
iterative_staged.py): the refusals, the checkpoint's statistics and
matches, and the pose update.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from impx_torch.eval.evaluator import pair_generator
from impx_torch.eval.iterative import VALID_ITS, _pose_diff_deg
from impx_torch.models.fast import _swap_half, encode_stacked
from impx_torch.ops.kernels.sinkhorn import sinkhorn_fused_stats, sinkhorn_stats_reference
from impx_torch.ops.matching import matches_from_stats
from impx_torch.ransac.pose_solver import estimate_pose_from_matches, prior_essential

# samples(keys, idx0, ms0) -> [P, H, S]: the minimal sets of P pairs in place
# of the generators' draws, keys[i] the (seed, index) that would seed pair
# i's generator (a test hook: impx's own draws)
SamplesHook = Callable[[list, torch.Tensor, torch.Tensor], torch.Tensor]
STATE_KEYS = ("indices0", "mscores0", "R", "t", "has_pose", "converged", "stopped_at")


def check_loop_model(model, with_uncertainty: bool = False) -> None:
    """Refuse what impx's three loops do not serve: batch norm (impx
    asserts norm_fn == 'in'), and the log-OT and dual-softmax heads, which
    impx's loops ignore, scoring with the dustbin Sinkhorn whatever the
    config says (ROADMAP section C). with_uncertainty needs AdaGMN."""
    cfg = model.config
    if cfg.norm_fn != "in":
        raise ValueError(f"the on-device loops need norm_fn='in', not {cfg.norm_fn!r}")
    if cfg.log_ot:
        raise ValueError("the on-device loops score with the dustbin Sinkhorn; a log_ot model "
                         "would run another head than it was trained with")
    if not cfg.with_sinkhorn:
        raise ValueError("the on-device loops score with the dustbin Sinkhorn; a dual-softmax model "
                         "(with_sinkhorn=False) would run another head than it was trained with")
    if with_uncertainty and not hasattr(model, "_pool_from_masses"):
        raise ValueError("with_uncertainty pools keypoints: it needs an AdaGMN (EIMP) model")


def initial_state(b: int, n: int, n_layers: int, device) -> dict:
    """Per-pair outputs before any checkpoint: no pose, no match, not
    converged, stopped_at n_layers."""
    return {"R": torch.eye(3, device=device).expand(b, 3, 3), "t": torch.zeros((b, 3), device=device),
            "has_pose": torch.zeros((b,), dtype=torch.bool, device=device),
            "converged": torch.zeros((b,), dtype=torch.bool, device=device),
            "indices0": torch.full((b, n), -1, dtype=torch.long, device=device),
            "mscores0": torch.zeros((b, n), device=device),
            "stopped_at": torch.full((b,), n_layers, dtype=torch.long, device=device)}


def stats_and_matches(model, dist, keep0, keep1, match_ratio: float):
    """Kernel 2's statistics of the dustbin Sinkhorn on dist [P, N, M] (its
    plain version when the model runs without kernels) under the keep
    masks, and the mutual-NN matches at match_ratio: (stats, idx0, ms0)."""
    stats_fn = sinkhorn_fused_stats if model.use_kernels else sinkhorn_stats_reference
    stats = stats_fn(dist, model.bin_score, model.config.sinkhorn_iterations, keep0, keep1)
    idx0, _, ms0, _ = matches_from_stats(stats["max0"], stats["idx0"], stats["idx1"], match_ratio, keep0, keep1)
    return stats, idx0, ms0


def solve_poses(keys: list, x0n, x1n, idx0, ms0, thresh, state: dict, *, num_hypotheses: int,
                sample_size: int, ransac_bucket: int, samples: SamplesHook | None = None) -> dict:
    """The checkpoint's poses of P pairs in one batched solve, warm-started
    from each pair's previous pose; pair i draws from
    pair_generator(device, *keys[i])."""
    drawn = None
    gens = [None] * len(keys)
    if samples is not None:
        drawn = samples(keys, idx0, ms0)
    else:
        gens = [pair_generator(idx0.device, seed, index) for seed, index in keys]
    return estimate_pose_from_matches(gens, x0n, x1n, idx0, ms0, thresh, bucket=ransac_bucket,
                                      num_hypotheses=num_hypotheses, sample_size=sample_size,
                                      E_init=prior_essential(state["R"], state["t"], state["has_pose"]),
                                      samples=drawn)


def update_state(state: dict, active, idx0, ms0, pose: dict, stop_at, *, min_kpts: int,
                 pose_stop_deg: float) -> dict:
    """One checkpoint's update of the pairs in `active` (the others keep
    their outputs): the pose difference to the previous pose, then the pose;
    a pair converges once it moved at most pose_stop_deg with at least
    min_kpts matches, and then outputs its pose inliers and stopped_at =
    stop_at (an int, or a tensor a pair)."""
    m_valid = idx0 > -1
    n_matches = m_valid.sum(dim=1)
    enough = n_matches >= min_kpts
    pose_ok = pose["num_inliers"] >= 5
    diff = torch.where(state["has_pose"] & pose_ok & enough,
                       _pose_diff_deg(state["R"], state["t"], pose["R"], pose["t"]), torch.inf)
    newly = active & enough & (diff <= pose_stop_deg) & ~state["converged"]
    upd = active & enough & pose_ok
    inlier_idx0 = torch.where(m_valid & pose["inliers"], idx0, -1)
    return {
        "R": torch.where(upd[:, None, None], pose["R"], state["R"]),
        "t": torch.where(upd[:, None], pose["t"], state["t"]),
        "has_pose": torch.where(active, enough & pose_ok, state["has_pose"]),
        "indices0": torch.where(newly[:, None], inlier_idx0,
                                torch.where(active[:, None], idx0, state["indices0"])),
        "mscores0": torch.where(active[:, None], ms0, state["mscores0"]),
        "stopped_at": torch.where(newly, stop_at, state["stopped_at"]),
        "converged": state["converged"] | newly,
    }


@torch.no_grad()
def iterative_fused_batched(model, data: dict[str, Any], seeds: Sequence[int], norm_threshs,
                            valid_its: Sequence[int] = VALID_ITS, match_ratio: float = 0.1, min_kpts: int = 25,
                            pose_stop_deg: float = 1.5, num_hypotheses: int = 256, sample_size: int = 5,
                            ransac_bucket: int = 512, with_uncertainty: bool = False, mscore_base: float = 0.2,
                            samples: SamplesHook | None = None) -> dict[str, Any]:
    """B pairs through the loop in lockstep (impx's
    iterative_fused_batched). data: the standard feed [B, N, ...] plus
    x0n/x1n [B, N, 2] (intrinsics-normalised), on the model's device or
    moved there; seeds: one a layer; norm_threshs [B] (or a float).

    Returns indices0, mscores0 [B, N], R [B, 3, 3], t [B, 3], has_pose,
    converged, stopped_at [B] and keep0, keep1 [B, N] (the keep masks after
    the last pool) as tensors; n_steps (layer steps run), checkpoints and
    host_reads as ints."""
    cfg = model.config
    check_loop_model(model, with_uncertainty)
    n_layers = cfg.n_layers
    if len(seeds) != n_layers:
        raise ValueError(f"want one seed a layer ({n_layers}), got {len(seeds)}")
    data = model._on_device(data)
    desc, keep0, keep1, (zq, zk), b, n = encode_stacked(model, data)
    dev = desc.device
    x0n, x1n = data["x0n"], data["x1n"]
    thresh = torch.as_tensor(norm_threshs, dtype=torch.float32, device=dev).expand(b)
    state = initial_state(b, n, n_layers, dev)
    kw = dict(ac_fn=cfg.ac_fn, use_kernels=model.use_kernels)
    qk_self = qk_cross = (zq, zk)
    steps = checkpoints = reads = 0
    for it in range(n_layers):
        keep, keep_swap = torch.cat([keep0, keep1]), torch.cat([keep1, keep0])
        delta, qk_self = model.gnn[2 * it](desc, desc, qk_self, keep, keep, **kw)
        desc = desc + delta
        delta, qk_cross = model.gnn[2 * it + 1](desc, _swap_half(desc), qk_cross, keep_swap, keep, **kw)
        desc = desc + delta
        steps += 1
        if it not in valid_its:
            continue
        checkpoints += 1
        dist = model.compute_distance(desc[:b].float(), desc[b:].float(), layer_id=it)
        stats, idx0, ms0 = stats_and_matches(model, dist, keep0, keep1, match_ratio)
        pose = solve_poses([(seeds[it], i) for i in range(b)], x0n, x1n, idx0, ms0, thresh, state,
                           num_hypotheses=num_hypotheses, sample_size=sample_size,
                           ransac_bucket=ransac_bucket, samples=samples)
        active = ~state["converged"]
        state = update_state(state, active, idx0, ms0, pose, it + 1, min_kpts=min_kpts,
                             pose_stop_deg=pose_stop_deg)
        if with_uncertainty:
            n_matches = (idx0 > -1).sum(dim=1)
            ratio = torch.where(n_matches > 0, pose["num_inliers"] / n_matches.clamp(min=1), 0.0)
            th = torch.where(ratio > 0, mscore_base * ratio, mscore_base)[:, None]
            masses = model._key_masses(qk_self, qk_cross, keep0, keep1, keep0, keep1)
            new0, new1 = model._pool_from_masses(stats["rowmass"], stats["colmass"], *masses, keep0, keep1, th,
                                                 cfg.n_min_tokens)
            keep0 = torch.where(active[:, None], new0, keep0)
            keep1 = torch.where(active[:, None], new1, keep1)
        reads += 1
        if bool(state["converged"].all()):   # the one host read a checkpoint
            break
    return {**state, "keep0": keep0, "keep1": keep1, "n_steps": steps, "checkpoints": checkpoints,
            "host_reads": reads}


def run_iterative_fused(model, data: dict[str, Any], seed: int, norm_threshs, **kw) -> dict[str, Any]:
    """`iterative_fused_batched` with a seed a layer derived from `seed`
    (impx's run_iterative_fused splits one key over the layers)."""
    n_layers = model.config.n_layers
    return iterative_fused_batched(model, data, [seed * n_layers + it for it in range(n_layers)], norm_threshs,
                                   **kw)
