"""The iterative loop with staged cohorts (impx/eval/iterative_staged.py):
a queue of Q pairs drained in cohorts of pairs at the same depth.

A stage is the segment of layers between two consecutive checkpoints.
Every pair of a cohort is at the same stage, so the segment runs the
model's own layers (static weights, no per-slot gathers, as the lockstep
loop) and checkpoints once at its end. A pair that converges leaves the
schedule; the others wait, queue-indexed, for the next cohort of their
depth. Each step takes the fullest cohort (at most `batch` pairs; ties to
the deepest stage, which drains the queue), members first in a stable
order.

impx's `lax.switch` on the chosen stage is a host choice here: the host
reads the stage, whether any pair is left and the cohort's pair ids (for
their RANSAC generators) in one small tensor a step, then runs that
segment's layers. A pair draws from a fresh `pair_generator(device, seed,
pair_id)` at each of its checkpoints, as in the refill loop, so results do
not depend on the cohort or the queue order.

The carried q/k of the shared layers cross a segment boundary only when a
segment after the first starts with a shared layer (`carry_qk`): never at
the published checkpoints, whose segments start on even iterations, but,
for example, at valid_its (1, 2, 3, 4, 5) over 6 layers.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from impx_torch.eval.iterative import VALID_ITS
from impx_torch.eval.iterative_fused import (
    STATE_KEYS, SamplesHook, check_loop_model, initial_state, solve_poses, stats_and_matches, update_state)
from impx_torch.models.fast import _swap_half, encode_stacked


def _segments(n_layers: int, valid_its: Sequence[int]) -> list[tuple[tuple[int, ...], int | None]]:
    """Layers 0..n_layers-1 split at the checkpoints: (layers, the checkpoint
    after the last of them, or None for trailing layers with none)."""
    segs, start = [], 0
    for b in sorted(i for i in valid_its if i < n_layers):
        segs.append((tuple(range(start, b + 1)), b))
        start = b + 1
    if start < n_layers:
        segs.append((tuple(range(start, n_layers)), None))
    return segs


@torch.no_grad()
def iterative_staged_queue(model, queue: dict[str, Any], seed: int, batch: int = 8,
                           valid_its: Sequence[int] = VALID_ITS, match_ratio: float = 0.1, min_kpts: int = 25,
                           pose_stop_deg: float = 1.5, num_hypotheses: int = 256, sample_size: int = 5,
                           ransac_bucket: int = 512, samples: SamplesHook | None = None) -> dict[str, Any]:
    """Drain a queue of Q pairs through depth-aligned cohorts of at most
    `batch` pairs (impx's iterative_staged_queue). queue as
    `iterative_refill_queue`'s.

    Returns per queue index indices0, mscores0 [Q, N], R [Q, 3, 3], t
    [Q, 3], has_pose, converged, stopped_at [Q] as tensors; n_steps (cohort
    steps), layer_steps (the layers run over all steps), completed, checkpoints
    and host_reads as ints."""
    cfg = model.config
    check_loop_model(model)
    nL = cfg.n_layers
    segs = _segments(nL, valid_its)
    S = len(segs)   # tag S: done
    sharing = [layer.shared for layer in model.gnn]
    carry_qk = any(sharing[2 * layers[0]] or sharing[2 * layers[0] + 1] for layers, _ in segs[1:])
    queue = model._on_device(queue)
    qdesc, valid0_q, valid1_q, (zq, _), Q, n = encode_stacked(model, queue)
    dev = qdesc.device
    B = min(batch, Q)
    pair_ids = queue.get("pair_ids")
    pair_ids = torch.arange(Q, device=dev) if pair_ids is None else pair_ids.long()
    thresh_q = torch.as_tensor(queue["norm_threshs"], dtype=torch.float32, device=dev).expand(Q)
    kw = dict(ac_fn=cfg.ac_fn, use_kernels=model.use_kernels)

    # each pair's evolving state, queue-indexed; desc and q/k [Q, 2, ...] (the two images)
    buf = {"desc": torch.stack([qdesc[:Q], qdesc[Q:]], 1), **initial_state(Q, n, nL, dev)}
    buf["R"] = buf["R"].contiguous()
    if carry_qk:
        for name in ("qs_q", "qs_k", "qc_q", "qc_k"):
            buf[name] = zq.new_zeros((Q, 2) + zq.shape[1:])
    tags = torch.zeros((Q,), dtype=torch.long, device=dev)
    stage_ids = torch.arange(S, device=dev)
    halves = lambda x: torch.cat([x[:, 0], x[:, 1]])       # [B, 2, ...] -> [2B, ...]  # noqa: E731
    pairs_of = lambda x: torch.stack([x[:B], x[B:]], 1)    # [2B, ...] -> [B, 2, ...]  # noqa: E731

    def choose():
        """The fullest cohort (ties to the deepest stage) and its members
        first, in a stable order; one host read: (any pair left, the stage,
        the cohort's pair ids)."""
        counts = torch.bincount(tags, minlength=S + 1)[:S]
        score = torch.where(counts > 0, counts.clamp(max=B) * S + stage_ids, -1)
        s_star = score.argmax()
        in_stage = tags == s_star
        idx = torch.argsort((~in_stage).to(torch.int32), stable=True)[:B]
        vals = torch.cat([score.max().view(1), s_star.view(1), pair_ids[idx]]).tolist()
        return vals[0] >= 0, vals[1], vals[2:], idx, in_stage[idx]

    steps = layer_steps = checkpoints = reads = 0
    completed = Q
    while steps < Q * S:
        left, s, cohort_pairs, idx, active = choose()
        reads += 1
        if not left:
            break
        layers, ckpt = segs[s]
        desc = halves(buf["desc"][idx])
        keep0, keep1 = valid0_q[idx], valid1_q[idx]
        keep, keep_swap = torch.cat([keep0, keep1]), torch.cat([keep1, keep0])
        if carry_qk:
            qk_self = (halves(buf["qs_q"][idx]), halves(buf["qs_k"][idx]))
            qk_cross = (halves(buf["qc_q"][idx]), halves(buf["qc_k"][idx]))
        else:   # every segment starts with a layer that projects its own q/k
            qk_self = qk_cross = None
        st = {name: buf[name][idx] for name in STATE_KEYS}
        for li in layers:
            delta, qk_self = model.gnn[2 * li](desc, desc, qk_self, keep, keep, **kw)
            desc = desc + delta
            delta, qk_cross = model.gnn[2 * li + 1](desc, _swap_half(desc), qk_cross, keep_swap, keep, **kw)
            desc = desc + delta
        layer_steps += len(layers)
        if ckpt is not None:
            dist = model.compute_distance(desc[:B].float(), desc[B:].float(), layer_id=ckpt)
            _, idx0, ms0 = stats_and_matches(model, dist, keep0, keep1, match_ratio)
            pose = solve_poses([(seed, pid) for pid in cohort_pairs], queue["x0n"][idx], queue["x1n"][idx], idx0,
                               ms0, thresh_q[idx], st, num_hypotheses=num_hypotheses, sample_size=sample_size,
                               ransac_bucket=ransac_bucket, samples=samples)
            st = update_state(st, active & ~st["converged"], idx0, ms0, pose, ckpt + 1, min_kpts=min_kpts,
                              pose_stop_deg=pose_stop_deg)
            checkpoints += 1

        # scatter back (the entries of idx are distinct; the cohort's other
        # slots write back what they gathered)
        def put(name, value):
            old = buf[name][idx]
            buf[name][idx] = torch.where(active.reshape((B,) + (1,) * (old.dim() - 1)), value, old)

        put("desc", pairs_of(desc))
        if carry_qk:
            for name, value in (("qs_q", qk_self[0]), ("qs_k", qk_self[1]), ("qc_q", qk_cross[0]),
                                ("qc_k", qk_cross[1])):
                put(name, pairs_of(value))
        for name in STATE_KEYS:
            put(name, st[name])
        new_tag = torch.where(st["converged"], S, S if s == S - 1 else s + 1)
        tags[idx] = torch.where(active, new_tag, tags[idx])
        steps += 1
    else:   # the step bound ended the loop: read the count
        completed = int((tags >= S).sum())
        reads += 1
    return {**{name: buf[name] for name in STATE_KEYS}, "n_steps": steps, "layer_steps": layer_steps,
            "completed": completed, "checkpoints": checkpoints, "host_reads": reads}


# impx's run_iterative_staged stacks the parameters first; the loop runs the model's own layers
run_iterative_staged = iterative_staged_queue
