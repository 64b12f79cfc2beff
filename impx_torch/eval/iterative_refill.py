"""The iterative loop with slot refill (impx/eval/iterative_refill.py): a
queue of Q pairs drained through B slots, each slot at its own depth.

The lockstep loop (impx_torch/eval/iterative_fused.py) makes every pair of a
batch wait for the batch's slowest; here a slot whose pair converged (or ran
out of layers) hands its results to the queue-indexed outputs and takes the
next pair from the queue head:
  * each slot gathers its own layer's weights from `stack_params`, so the
    projections, the merge and the MLP are batched products (`torch.bmm`)
    with a weight a slot; the attention is kernel 1;
  * a checkpoint fires for the slots whose layer index is in valid_its,
    scored through kernel 2's statistics for every slot and applied to
    those;
  * slots retire only on even steps, so every slot's layer parity is the
    step's and the checkpoints of all slots fall on shared steps;
  * a pair's RANSAC draws depend on the pair alone: a fresh
    `pair_generator(device, seed, pair_id)` at each of its checkpoints
    (impx folds the pair id into one key), so results do not depend on the
    slot, the step or the queue order.

impx's while_loop and its `lax.cond` around the checkpoint are host
decisions here: after each step the host reads one small tensor (the
completed count, whether the next step checkpoints, and each slot's pair
id for its generator). Retired results go to output buffers with one extra
sink row, which takes the writes of slots that do not retire (impx's
scatter with mode='drop'), and is sliced off at the end.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from impx_torch.eval.iterative import VALID_ITS
from impx_torch.eval.iterative_fused import (
    STATE_KEYS, SamplesHook, check_loop_model, initial_state, solve_poses, stats_and_matches, update_state)
from impx_torch.models.fast import encode_stacked, stack_params
from impx_torch.ops import norms
from impx_torch.ops.kernels.attention import mha_fused, mha_reference
from impx_torch.ops.mlp import activation


def _dense_b(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A dense map with a weight a batch entry: x [T, N, in], p['w']
    [T, in, out], p['b'] [T, out]; product and bias add in x's dtype."""
    return torch.bmm(x, p["w"].to(x.dtype)) + p["b"][:, None, :].to(x.dtype)


def _proj_heads_b(p: dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """`_dense_b` into a contiguous [T, H, N, dh], head-minor channels
    (impx/eval/iterative_refill.py:_proj_heads_b)."""
    y = _dense_b(p, x)
    t, n, c = y.shape
    return y.reshape(t, n, c // num_heads, num_heads).permute(0, 3, 1, 2).contiguous()


def _merge_heads_b(p: dict, x: torch.Tensor) -> torch.Tensor:
    """[T, H, N, dh] -> `_dense_b` -> [T, N, D], input channel c = d * H + h."""
    t, h, n, dh = x.shape
    return _dense_b(p, x.permute(0, 2, 3, 1).reshape(t, n, dh * h))


def _attn_block_slotted(L: dict, x, source, qk_carry, key_mask, query_mask, num_heads: int, ac_fn: str,
                        use_kernels: bool):
    """One attentional-propagation layer whose weights L carry a leading
    batch axis (impx/eval/iterative_refill.py:_attn_block_slotted): a slot
    whose layer shares attention ('shared') attends with the carried q/k.
    Returns (delta, (q, k))."""
    q = _proj_heads_b(L["q"], x, num_heads)
    k = _proj_heads_b(L["k"], source, num_heads)
    v = _proj_heads_b(L["v"], source, num_heads)
    shared = L["shared"][:, None, None, None]
    q = torch.where(shared, qk_carry[0], q)
    k = torch.where(shared, qk_carry[1], k)
    out = (mha_fused if use_kernels else mha_reference)(q, k, v, key_mask)
    message = _merge_heads_b(L["merge"], out.to(x.dtype))
    h = _dense_b(L["mlp0"], torch.cat([x, message], dim=-1))
    h = activation(norms.instance_norm(h.float(), mask=query_mask).to(h.dtype), ac_fn)
    return _dense_b(L["mlp1"], h), (q, k)


def _gather_layers(tree: dict, li: torch.Tensor) -> dict:
    """Each slot's layer of a stacked dict, on both image halves: leaf
    [L, ...] -> [2B, ...]."""
    out = {}
    for name, x in tree.items():
        if isinstance(x, dict):
            out[name] = _gather_layers(x, li)
        else:
            g = x[li]
            out[name] = torch.cat([g, g])
    return out


@torch.no_grad()
def iterative_refill_queue(model, queue: dict[str, Any], seed: int, slots: int = 16,
                           valid_its: Sequence[int] = VALID_ITS, match_ratio: float = 0.1, min_kpts: int = 25,
                           pose_stop_deg: float = 1.5, num_hypotheses: int = 256, sample_size: int = 5,
                           ransac_bucket: int = 512, samples: SamplesHook | None = None) -> dict[str, Any]:
    """Drain a queue of Q pairs through `slots` slots (impx's
    iterative_refill_queue). queue: descriptors0/1 [Q, N, D],
    norm_keypoints0/1 [Q, N, 2], scores0/1 [Q, N], x0n/x1n [Q, N, 2],
    norm_threshs [Q], optional valid0/1 [Q, N] and pair_ids [Q] (a pair's
    identity for its RANSAC draws; the queue position by default), on the
    model's device or moved there.

    Returns per queue index indices0, mscores0 [Q, N], R [Q, 3, 3], t
    [Q, 3], has_pose, converged, stopped_at [Q] as tensors; n_steps,
    completed, checkpoints and host_reads as ints."""
    cfg = model.config
    check_loop_model(model)
    nL, B, h = cfg.n_layers, slots, cfg.num_heads
    queue = model._on_device(queue)
    qdesc, valid0_q, valid1_q, (zq, _), Q, n = encode_stacked(model, queue)
    qdesc0, qdesc1 = qdesc[:Q], qdesc[Q:]
    dev = qdesc.device
    pair_ids = queue.get("pair_ids")
    pair_ids = torch.arange(Q, device=dev) if pair_ids is None else pair_ids.long()
    thresh_q = torch.as_tensor(queue["norm_threshs"], dtype=torch.float32, device=dev).expand(Q)
    stack = stack_params(model)
    check_table = torch.tensor([i in valid_its for i in range(nL)], device=dev)
    kw = dict(num_heads=h, ac_fn=cfg.ac_fn, use_kernels=model.use_kernels)

    def load(state, refill, new_qidx):
        """(Re)load the slots of `refill` [B] bool with the pairs new_qidx
        [B] (read only where refill)."""
        qi = new_qidx.clamp(0, Q - 1)
        r1, r2 = refill[:, None], refill[:, None, None]
        r2b, r4 = torch.cat([r2, r2]), torch.cat([refill, refill])[:, None, None, None]
        fresh = {"desc": torch.where(r2b, torch.cat([qdesc0[qi], qdesc1[qi]]), state["desc"]),
                 "qk_self": tuple(torch.where(r4, 0, x) for x in state["qk_self"]),
                 "qk_cross": tuple(torch.where(r4, 0, x) for x in state["qk_cross"]),
                 "keep0": torch.where(r1, valid0_q[qi], state["keep0"]),
                 "keep1": torch.where(r1, valid1_q[qi], state["keep1"]),
                 "x0n": torch.where(r2, queue["x0n"][qi], state["x0n"]),
                 "x1n": torch.where(r2, queue["x1n"][qi], state["x1n"]),
                 "thresh": torch.where(refill, thresh_q[qi], state["thresh"]),
                 "li": torch.where(refill, 0, state["li"]),
                 "qidx": torch.where(refill, new_qidx, state["qidx"]),
                 "active": torch.where(refill, new_qidx < Q, state["active"])}
        blank = initial_state(B, n, nL, dev)
        for name in STATE_KEYS:
            mask = refill.reshape((B,) + (1,) * (blank[name].dim() - 1))
            fresh[name] = torch.where(mask, blank[name], state[name])
        return fresh

    def slot_need(state):
        """The slots that checkpoint after this step's layers."""
        return (check_table[state["li"].clamp(0, nL - 1)] & state["active"] & ~state["converged"]
                & (state["li"] < nL))

    def checkpoint(state, need, slot_pairs):
        """Every slot's checkpoint (at its own layer's final projection),
        applied to the slots of `need`."""
        li = state["li"].clamp(0, nL - 1)
        fw, fb = stack["final_w"][li], stack["final_b"][li][:, None, :]
        md0 = torch.bmm(state["desc"][:B].float(), fw) + fb
        md1 = torch.bmm(state["desc"][B:].float(), fw) + fb
        dist = torch.bmm(md0, md1.mT) / cfg.descriptor_dim ** 0.5
        _, idx0, ms0 = stats_and_matches(model, dist, state["keep0"], state["keep1"], match_ratio)
        pose = solve_poses([(seed, pid) for pid in slot_pairs], state["x0n"], state["x1n"], idx0, ms0,
                           state["thresh"], state, num_hypotheses=num_hypotheses, sample_size=sample_size,
                           ransac_bucket=ransac_bucket, samples=samples)
        return {**state, **update_state(state, need, idx0, ms0, pose, state["li"] + 1, min_kpts=min_kpts,
                                        pose_stop_deg=pose_stop_deg)}

    def read(state, completed):
        """The step's one host read: (completed, whether any slot checkpoints
        next, each slot's pair id)."""
        need = slot_need(state)
        pids = pair_ids[state["qidx"].clamp(0, Q - 1)]
        vals = torch.cat([completed.view(1), need.any().view(1).long(), pids]).tolist()
        return vals[0], bool(vals[1]), vals[2:]

    zeros = lambda *shape, **k: torch.zeros(shape, device=dev, **k)  # noqa: E731
    state = {"desc": torch.zeros((2 * B, n, cfg.descriptor_dim), dtype=qdesc.dtype, device=dev),
             "qk_self": (zq.new_zeros((2 * B,) + zq.shape[1:]),) * 2,
             "qk_cross": (zq.new_zeros((2 * B,) + zq.shape[1:]),) * 2,
             "keep0": zeros(B, n, dtype=torch.bool), "keep1": zeros(B, n, dtype=torch.bool),
             "x0n": zeros(B, n, 2), "x1n": zeros(B, n, 2), "thresh": zeros(B),
             "li": zeros(B, dtype=torch.long), "qidx": zeros(B, dtype=torch.long),
             "active": zeros(B, dtype=torch.bool), **initial_state(B, n, nL, dev)}
    state = load(state, torch.ones((B,), dtype=torch.bool, device=dev), torch.arange(B, device=dev))
    # one sink row past the queue takes the writes of the slots that do not retire
    results = {name: torch.cat([x, x[:1]]) for name, x in initial_state(Q, n, nL, dev).items()}
    next_ptr = torch.tensor(B, device=dev)
    completed = torch.zeros((), dtype=torch.long, device=dev)
    done_count, need_any, slot_pairs = read(state, completed)
    steps, checkpoints, reads = 0, 0, 1
    # parity-snapped retires add at most one idle step a pair
    max_steps = (nL + 2) * ((Q + B - 1) // B) + nL + 2
    while done_count < Q and steps < max_steps:
        keep = torch.cat([state["keep0"], state["keep1"]])
        keep_swap = torch.cat([state["keep1"], state["keep0"]])
        li = state["li"].clamp(0, nL - 1)
        desc = state["desc"]
        delta, qk_self = _attn_block_slotted(_gather_layers(stack["self"], li), desc, desc, state["qk_self"],
                                             keep, keep, **kw)
        desc = desc + delta
        delta, qk_cross = _attn_block_slotted(_gather_layers(stack["cross"], li), desc,
                                              torch.cat([desc[B:], desc[:B]]), state["qk_cross"], keep_swap,
                                              keep, **kw)
        state = {**state, "desc": desc + delta, "qk_self": qk_self, "qk_cross": qk_cross}
        if need_any:
            state = checkpoint(state, slot_need(state), slot_pairs)
            checkpoints += 1
        state["li"] = torch.where(state["active"] & (state["li"] < nL), state["li"] + 1, state["li"])

        # retire the finished slots on even steps, then refill them from the queue head
        done = state["active"] & (state["converged"] | (state["li"] >= nL)) & (steps % 2 == 0)
        qi = torch.where(done, state["qidx"], Q)
        for name in STATE_KEYS:
            results[name][qi] = state[name]
        n_done = done.long().sum()
        completed = completed + n_done
        offs = torch.cumsum(done.long(), 0) - done.long()
        state = load(state, done, torch.where(done, next_ptr + offs, state["qidx"]))
        next_ptr = next_ptr + n_done
        steps += 1
        done_count, need_any, slot_pairs = read(state, completed)
        reads += 1
    return {**{name: x[:Q] for name, x in results.items()}, "n_steps": steps, "completed": done_count,
            "checkpoints": checkpoints, "host_reads": reads}


# impx's run_iterative_refill stacks the parameters first; here the loop does
run_iterative_refill = iterative_refill_queue
