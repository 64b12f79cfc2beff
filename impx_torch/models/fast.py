"""The stacked-batch forwards of DGNNS (impx/models/fast.py:forward_scan :315)
and of AdaGMN, EIMP (forward_scan_eimp :731, forward_scan_eimp_compact :851),
and their training forwards (forward_train_scan :432,
forward_train_scan_eimp :952, forward_train_scan_eimp_compact :1110).

Both images of every pair go through each layer in one call, stacked on the
batch axis [2B, N, D]: self layers attend within the stack, cross layers to
the stack with its halves swapped. JAX's `scan` over iterations is a Python
loop here, and each layer knows statically whether it shares attention, so
a shared layer skips the q/k projections that the JAX scan computes and
discards (impx/models/fast.py:141, `shared_static=True`); the numbers are the
same. The per-layer body (`_attn_block`, `_tail`) is
impx_torch/models/gnn.py:AttentionalPropagation. The forwards here need no
homogeneous parameter stack; the slot-refill loop, whose slots sit at
different depths, gathers its layers from `stack_params`'s
(impx_torch/eval/iterative_refill.py).

The dtype contract (compute_dtype='bfloat16'): descriptors go to bf16 after
the keypoint encoding; projections, merges, bias adds and the residual add
run in bf16; the InstanceNorm inside each layer runs in fp32 and casts back;
the final projection, the distance and the Sinkhorn head run in fp32.

Without config.with_sinkhorn the score head is the dual softmax, whose plan
gives the matches and the pooling masses, where impx's fast path takes the
same branch (fast.py:295-312, :659-666, :778-786): kernel 2 is then not on
the path.

Training (`forward_train_scan`, impx/models/fast.py:432) runs the same
stacked forward under autograd with the model's score head and a GraphLoss
on every iteration ('all') or on the last ('last'): the log-OT head (kernel 7
forward, the plain fp32 head's gradient), the Sinkhorn plan (its plan kept in
bf16 inside the u/v loop under the bf16 stream) or the dual softmax (plain
autograd), plus the epipolar loss under config.with_geo. impx's route B
wraps a whole layer in one custom VJP (`_make_fused_layer` :165) only to
control what its rematerialised scan stores; the layer's tail and head
backward there are plain VJPs, which autograd computes the same way, so the
port writes only the attention core of route B by hand
(impx_torch/ops/kernels/attention.py:MhaLseFunction). GM's unrolled
training forward (impx_torch/models/gm.py:GM.forward_train) shares the
supervised head and the outputs (`supervised_head`, `train_outputs`).

EIMP's training scans (`forward_train_scan_eimp`, masked, and
`forward_train_scan_eimp_compact`, compacted) run every layer on route A
(kernel 1 forward, kernel 3 backward), whatever config.train_fused says, as
impx's EIMP scan does (its `_attn_block` has no route B). Each iteration's
plan comes from the model's differentiable score head and takes a loss
against the ground truth restricted to the kept keypoints from
first_it_to_update on; its matches (p = 0.2) give an accuracy averaged over
all iterations. The pooling iterations pool without gradient from that plan
and the key masses of kernel 6 on its standalone route (its own row-lse
launch: route A keeps no row lse).
"""
from __future__ import annotations

from typing import Any

import torch

from impx_torch.models.config import compaction_schedule
from impx_torch.ops.kernels.log_sinkhorn import (
    log_plan_from_uv, log_sinkhorn_fused_stats, log_sinkhorn_stats_reference)
from impx_torch.ops.kernels.sinkhorn import (
    sinkhorn_fused_stats, sinkhorn_plan_from_uv, sinkhorn_stats_reference)
from impx_torch.models.loss import geo_loss, graph_loss, loss_counts, matching_accuracy, maybe_epipolar_matrix
from impx_torch.ops.matching import matches_from_stats
from impx_torch.tools.profiling import span


def _swap_half(x: torch.Tensor) -> torch.Tensor:
    """Swap the two image halves of the stacked batch [2B, ...]."""
    b = x.shape[0] // 2
    return torch.cat([x[b:], x[:b]], dim=0)


def final_matches_from_desc(model, desc, b: int, valid0, valid1, p: float, with_scores: bool):
    """Last-iteration matches from the final stacked descriptors: final
    projection -> distance -> (log-)Sinkhorn statistics -> mutual-NN matches
    (impx/models/fast.py:265). Under config.log_ot the statistics are of the
    log plan, so the match scores are exp(max0) and 'scores' is the log plan.
    Without config.with_sinkhorn the score head (the dual softmax) builds the
    plan and the matches come from it, as impx's third branch
    (impx/models/fast.py:309-312)."""
    with span("impx.head"):
        cfg = model.config
        dist = model.compute_distance(desc[:b].float(), desc[b:].float(), layer_id=-1)
        if not cfg.with_sinkhorn:
            score = model.compute_score(dist, valid0, valid1)
            idx0, _, ms0, _ = model.compute_matches(score, p=p, valid0=valid0, valid1=valid1)
            return {"scores": [score if with_scores else None], "indices0": [idx0], "mscores0": [ms0]}
        if cfg.log_ot:
            stats_fn = log_sinkhorn_fused_stats if model.use_kernels else log_sinkhorn_stats_reference
            plan_fn = log_plan_from_uv
        else:
            stats_fn = sinkhorn_fused_stats if model.use_kernels else sinkhorn_stats_reference
            plan_fn = sinkhorn_plan_from_uv
        stats = stats_fn(dist, model.bin_score, cfg.sinkhorn_iterations, valid0, valid1)
        max0 = torch.exp(stats["max0"]) if cfg.log_ot else stats["max0"]
        idx0, _, ms0, _ = matches_from_stats(max0, stats["idx0"], stats["idx1"], p, valid0, valid1)
        score = (plan_fn(dist, model.bin_score, stats["u"], stats["v"], valid0, valid1)
                 if with_scores else None)
        return {"scores": [score], "indices0": [idx0], "mscores0": [ms0]}


def _encode(model, data: dict[str, Any], stream_dtype: torch.dtype | None = None):
    """Keypoint encoding of both images, stacked: (desc [2B, N, D] in
    `stream_dtype`, by default the compute dtype, valid0, valid1 [B, N] bool,
    B, N). Under sequence parallelism desc and N are this rank's block of
    the keypoints and valid0, valid1 cover all of them (GM.seq_rows)."""
    with span("impx.encode"):
        b, n = data["descriptors0"].shape[:2]
        if data["descriptors1"].shape[1] != n:
            raise ValueError("the stacked batch needs the same keypoint count in both "
                             "images; pad with valid0/valid1")
        valid0, valid1 = model._valid_masks(data, n, n)
        enc0 = model.encode_keypoint(model._norm_kpts(data, 0), data["scores0"], model.seq_rows(valid0))
        enc1 = model.encode_keypoint(model._norm_kpts(data, 1), data["scores1"], model.seq_rows(valid1))
        desc = torch.cat([data["descriptors0"] + enc0, data["descriptors1"] + enc1], dim=0)
        return desc.to(stream_dtype or model.compute_dtype), valid0, valid1, b, n


def encode_stacked(model, data: dict[str, Any]):
    """`_encode` plus zero q/k carries (impx/models/fast.py:_eimp_encode
    :850): (desc [2B, N, D] in the compute dtype, valid0, valid1 [B, N],
    zero_qk = (q, k) zeros [2B, H, N, dh] in the compute dtype, B, N). A
    shared layer never reads the zeros: the first layer of every model
    projects its own q/k."""
    desc, valid0, valid1, b, n = _encode(model, data)
    h = model.config.num_heads
    h_local = model.gnn[0].num_heads  # this rank's heads under tensor parallelism
    zero = torch.zeros((2 * b, h_local, n, model.config.descriptor_dim // h), dtype=desc.dtype, device=desc.device)
    return desc, valid0, valid1, (zero, zero), b, n


def stack_params(model) -> dict:
    """The model's layer weights with a leading n_layers axis
    (impx/models/fast.py:stack_params :61, `_full_layer` :41), built from
    its own parameters on each call: 'self' (layers 2i) and 'cross'
    (2i + 1), each a dict of q, k, v, merge, mlp0, mlp1 ({'w': [L, in, out],
    'b': [L, out]} in the compute dtype) and 'shared' [L]
    bool, a shared layer's q and k zeros; 'final_w' [L, D, D] and
    'final_b' [L, D] in fp32, where the checkpoints score."""
    cfg = model.config

    def dense(m):
        return {"w": m.weight.detach().to(model.compute_dtype), "b": m.bias.detach().to(model.compute_dtype)}

    def full(layer):
        if layer.shared:
            v, merge = dense(layer.proj), dense(layer.merge)
            q = k = {name: torch.zeros_like(x) for name, x in v.items()}
        else:
            q, k, v, merge = (dense(layer.attn[name]) for name in ("q", "k", "v", "merge"))
        mlp0, mlp1 = (dense(blk) for blk in layer.mlp.blocks)
        return {"q": q, "k": k, "v": v, "merge": merge, "mlp0": mlp0, "mlp1": mlp1}

    def stack(layers):
        return {name: {leaf: torch.stack([L[name][leaf] for L in layers]) for leaf in ("w", "b")}
                for name in layers[0]}

    kinds = {}
    for kind, first in (("self", 0), ("cross", 1)):
        layers = [model.gnn[2 * i + first] for i in range(cfg.n_layers)]
        kinds[kind] = {**stack([full(layer) for layer in layers]),
                       "shared": torch.tensor([layer.shared for layer in layers], device=model.device)}
    return {**kinds,
            "final_w": torch.stack([p.weight.detach().float() for p in model.final_proj]),
            "final_b": torch.stack([p.bias.detach().float() for p in model.final_proj])}


def forward_scan(model, data: dict[str, Any], p: float = 0.2, only_last: bool = True,
                 with_scores: bool = True):
    """DGNNS produce_matches on tensors already on the model's device. Returns
    the dict of GM.produce_matches; with_scores=False skips the plan."""
    cfg = model.config
    desc, valid0, valid1, b, _ = _encode(model, data)
    mask = torch.cat([valid0, valid1], dim=0)       # [2B, N]: the keys' masks
    mask_swap = torch.cat([valid1, valid0], dim=0)
    rows = model.seq_rows(mask)                     # the queries' (this rank's block)

    kw = dict(ac_fn=cfg.ac_fn, use_kernels=model.use_kernels)
    qk_self = qk_cross = None
    descs = []
    for i in range(cfg.n_layers):
        delta, qk_self = model.gnn[2 * i](desc, desc, qk_self, mask, rows, **kw)
        desc = desc + delta
        delta, qk_cross = model.gnn[2 * i + 1](desc, _swap_half(desc), qk_cross, mask_swap, rows, **kw)
        desc = desc + delta
        if not only_last:
            descs.append(desc)

    if only_last:
        return final_matches_from_desc(model, desc, b, valid0, valid1, p, with_scores)

    # per-iteration outputs through the plain score head (diagnostics/parity)
    out_scores, out_idx0, out_ms0 = [], [], []
    for li, d in enumerate(descs):
        dist = model.compute_distance(d[:b].float(), d[b:].float(), layer_id=li)
        score = model.compute_score(dist, valid0, valid1)
        idx0, _, ms0, _ = model.compute_matches(score, p=p, valid0=valid0, valid1=valid1)
        out_scores.append(score)
        out_idx0.append(idx0)
        out_ms0.append(ms0)
    return {"scores": out_scores, "indices0": out_idx0, "mscores0": out_ms0}


def supervised_head(model, desc0, desc1, layer_id: int, gt, epi, valid0, valid1, counts=None):
    """One supervised iteration (impx/models/fast.py:head_part :488,
    impx/models/gm.py:255-264): final projection layer_id, distance, the
    model's score head, then graph_loss of the plan (a log plan under the
    log-OT head) and, when epi is given, the geo_loss of its probabilities
    under 'geo'. counts (loss.loss_counts of gt): the terms are this rank's
    shares of the data-parallel global batch's. Returns (terms, score)."""
    with span("impx.head"):
        dist = model.compute_distance(desc0.float(), desc1.float(), layer_id=layer_id)
        score = model.compute_score(dist, valid0, valid1)
        terms = graph_loss(score, gt, scores_are_log=model.scores_are_log, counts=counts)
        if epi is not None:
            terms["geo"] = geo_loss(torch.exp(score) if model.scores_are_log else score, epi, valid0, valid1,
                                    n_pairs=None if counts is None else counts[0])
        return terms, score


def train_outputs(model, terms: dict, score, gt, valid0, valid1, counts=None) -> dict:
    """The dict of impx's forward_train from the supervised terms (meaned over
    the supervised iterations) and the last plan: loss = corr + incorr + neg
    (+ geo_weight * geo under with_geo), its terms, geo_loss (0 without
    with_geo), matching_scores0 and matches0 of the last plan, and the
    accuracy counters (shares of the global batch's under `counts`)."""
    with torch.no_grad():
        idx0, _, ms0, _ = model.compute_matches(score, p=model.config.match_threshold, valid0=valid0,
                                                valid1=valid1)
        acc = matching_accuracy(idx0, gt, n_pairs=None if counts is None else counts[0])
    return loss_outputs(model.config, terms, idx0, ms0, acc)


def loss_outputs(cfg, terms: dict, idx0, ms0, acc: dict) -> dict:
    """`train_outputs`'s dict from the meaned terms, the matches and
    their scores, and the accuracy counters."""
    matching = terms["corr"] + terms["incorr"] + terms["neg"]
    loss = matching + cfg.geo_weight * terms["geo"] if "geo" in terms else matching
    geo = terms.get("geo", torch.zeros((), dtype=torch.float32, device=matching.device))
    return {"loss": loss, "matching_loss": matching, "matching_loss_corr": terms["corr"],
            "matching_loss_incorr": terms["incorr"], "matching_loss_neg": terms["neg"],
            "geo_loss": geo, "matching_scores0": ms0, "matches0": idx0, **acc}


def zero_terms(with_geo: bool, device) -> dict:
    """The supervised terms' running sums at 0: corr, incorr, neg (and geo)."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return dict.fromkeys(("corr", "incorr", "neg") + (("geo",) if with_geo else ()), zero)


def forward_train_scan(model, data: dict[str, Any]) -> dict[str, Any]:
    """DGNNS training forward on tensors already on the model's device
    (impx/models/fast.py:432): data as `forward_scan`'s plus matching_mask
    [B, N+1, M+1] (and, for with_geo, keypoints0/1, intrinsics0/1 and gt_E).
    Returns the dict of `train_outputs`."""
    cfg = model.config
    gt = data["matching_mask"]
    epi = maybe_epipolar_matrix(model.whole_keypoints(data), cfg.geo_clamp) if cfg.with_geo else None
    counts = loss_counts(gt, model.data_group)
    desc, valid0, valid1, b, _ = _encode(model, data)
    mask = torch.cat([valid0, valid1], dim=0)
    mask_swap = torch.cat([valid1, valid0], dim=0)
    rows = model.seq_rows(mask)
    kw = dict(ac_fn=cfg.ac_fn, use_kernels=model.use_kernels, lse_core=cfg.train_fused)

    def head(desc, layer_id, terms):
        t, score = supervised_head(model, desc[:b], desc[b:], layer_id, gt, epi, valid0, valid1, counts)
        return {k: terms[k] + t[k] for k in terms}, score

    terms = zero_terms(epi is not None, desc.device)
    sup_all = cfg.train_supervision == "all"
    qk_self = qk_cross = score = None
    for i in range(cfg.n_layers):
        delta, qk_self = model.gnn[2 * i](desc, desc, qk_self, mask, rows, **kw)
        desc = desc + delta
        delta, qk_cross = model.gnn[2 * i + 1](desc, _swap_half(desc), qk_cross, mask_swap, rows, **kw)
        desc = desc + delta
        if sup_all:
            terms, score = head(desc, i, terms)
    if sup_all:
        terms = {k: x / cfg.n_layers for k, x in terms.items()}
    else:
        terms, score = head(desc, -1, terms)
    return train_outputs(model, terms, score, gt, valid0, valid1, counts)


# --------------------------------------------------------------------- EIMP
def _eimp_do_pool(cfg) -> list[bool]:
    """Per iteration: does it pool? The iterations whose self layer shares
    attention, from first_it_to_update on (impx/models/fast.py:724)."""
    sharing = cfg.sharing_layers(True)
    return [sharing[2 * i] and i >= cfg.first_it_to_update for i in range(cfg.n_layers)]


def _eimp_step(model, i: int, state: tuple, b: int, p: float, th: float, do_pool: bool):
    """Iteration i of EIMP (impx/models/fast.py:_eimp_make_body :607).

    state = (desc, qk_self, qk_cross, keep0, keep1, full0, full1). Attention
    keys see the keep masks; queries, InstanceNorm and the attention-mass
    sums see full0/full1, every real keypoint of the current tensors (the
    reference keeps discarded keypoints as queries). Under sequence
    parallelism the keep masks cover all keypoints, full0/full1 this rank's
    block, and the masses are summed over the sequence group. Then the per-iteration
    head: final_proj[i], Sinkhorn statistics (or, without
    config.with_sinkhorn, the dual-softmax plan) and matches under the keep
    masks, and, on pooling iterations, two key-mass launches and the pooling rule.
    On the kernel path a pooling iteration's two layers also return their
    row lse (kernel 4), over the very q, k and key masks that the masses
    use, so each mass is one pass; the plain path computes them from q, k.
    Returns (state, (indices0, mscores0, u, v, keep0, keep1 used))."""
    cfg = model.config
    desc, qk_self, qk_cross, keep0, keep1, full0, full1 = state
    keep = torch.cat([keep0, keep1], dim=0)
    keep_swap = torch.cat([keep1, keep0], dim=0)
    full = torch.cat([full0, full1], dim=0)
    kw = dict(ac_fn=cfg.ac_fn, use_kernels=model.use_kernels, with_lse=do_pool and model.use_kernels)
    delta, qk_self, *lse_self = model.gnn[2 * i](desc, desc, qk_self, keep, full, **kw)
    desc = desc + delta
    delta, qk_cross, *lse_cross = model.gnn[2 * i + 1](desc, _swap_half(desc), qk_cross, keep_swap, full,
                                                      **kw)
    desc = desc + delta

    with span("impx.head"):
        dist = model.compute_distance(desc[:b].float(), desc[b:].float(), layer_id=i)
        if cfg.with_sinkhorn:
            stats_fn = sinkhorn_fused_stats if model.use_kernels else sinkhorn_stats_reference
            stats = stats_fn(dist, model.bin_score, cfg.sinkhorn_iterations, keep0, keep1)
            idx0, _, ms0, _ = matches_from_stats(stats["max0"], stats["idx0"], stats["idx1"], p, keep0, keep1)
            rowmass, colmass, u, v = stats["rowmass"], stats["colmass"], stats["u"], stats["v"]
        else:
            # the dual-softmax head: the plan itself, u and v zero
            # (impx/models/fast.py:659-666)
            score = model.compute_score(dist, keep0, keep1)
            idx0, _, ms0, _ = model.compute_matches(score, p=p, valid0=keep0, valid1=keep1)
            inner = score[:, :-1, :-1]
            rowmass, colmass = inner.sum(dim=2), inner.sum(dim=1)
            u = v = torch.zeros((b, keep0.shape[1] + 1), dtype=torch.float32, device=dist.device)
    out = (idx0, ms0, u, v, keep0, keep1)
    if do_pool:
        with span("impx.pool"):
            masses = model._key_masses(qk_self, qk_cross, keep0, keep1, full0, full1, *lse_self, *lse_cross)
            keep0, keep1 = model._pool_from_masses(rowmass, colmass, *masses, keep0, keep1, th,
                                                   cfg.n_min_tokens)
    return (desc, qk_self, qk_cross, keep0, keep1, full0, full1), out


def forward_scan_eimp(model, data: dict[str, Any], p: float = 0.2, mscore_th: float = 0.1,
                      uncertainty_ratio: float = 1.0, only_last: bool = False,
                      with_scores: bool = True):
    """AdaGMN produce_matches with mask-only pooling: the tensors keep every
    keypoint and pooling shrinks the keep masks (impx/models/fast.py:731).
    Returns 'scores' (the last iteration's fp32 plan, rebuilt from its u, v
    and keep masks, or None), 'indices0' and 'mscores0' per iteration (or the
    last only), and the final 'keep0'/'keep1' [B, N] bool."""
    cfg = model.config
    desc, valid0, valid1, b, _ = _encode(model, data)
    th = mscore_th * uncertainty_ratio
    state = (desc, None, None, valid0, valid1, model.seq_rows(valid0), model.seq_rows(valid1))
    outs = []
    for i, do_pool in enumerate(_eimp_do_pool(cfg)):
        state, out = _eimp_step(model, i, state, b, p, th, do_pool)
        outs.append(out)
    desc, keep0, keep1 = state[0], state[3], state[4]

    score = None
    if with_scores:
        _, _, u, v, k0, k1 = outs[-1]
        dist = model.compute_distance(desc[:b].float(), desc[b:].float(), layer_id=-1)
        score = (sinkhorn_plan_from_uv(dist, model.bin_score, u, v, k0, k1) if cfg.with_sinkhorn
                 else model.compute_score(dist, k0, k1))
    picked = outs[-1:] if only_last else outs
    return {"scores": [score], "indices0": [o[0] for o in picked],
            "mscores0": [o[1] for o in picked], "keep0": keep0, "keep1": keep1}


def _stable_topk_indices(keep: torch.Tensor, k: int) -> torch.Tensor:
    """The first k slots of each row with kept keypoints first, each class in
    its original order (impx/models/fast.py:801): every survivor is gathered
    when there are at most k."""
    order = torch.sort(keep.to(torch.uint8), dim=1, descending=True, stable=True).indices
    return order[:, :k]


def _compact_gather(desc, qk_self, qk_cross, keep0, keep1, g0, g1, i0, i1):
    """Gather both images into the slots i0, i1 [B, k] of `_stable_topk_indices`
    (impx/models/fast.py:813, with one difference). Rows [:B] of the stack
    are image 0 and rows [B:] image 1, for desc, the self q/k and the cross
    q. The cross k was projected from the swapped stack, so its rows [:B]
    hold image 1's keys and take image 1's indices, and rows [B:] take image
    0's. impx gathers the cross k with the unswapped indices (fast.py:827-830),
    which changes the result when the first iteration after a gather shares
    attention and reuses that k. Differentiable in desc and the q/k."""
    idx = torch.cat([i0, i1], dim=0)
    idx_swap = torch.cat([i1, i0], dim=0)

    def rows(t, i):  # [2B, N, D] -> [2B, k, D]
        return torch.gather(t, 1, i[:, :, None].expand(-1, -1, t.shape[2]))

    def heads(t, i):  # [2B, H, N, dh] -> [2B, H, k, dh]
        return torch.gather(t, 2, i[:, None, :, None].expand(-1, t.shape[1], -1, t.shape[3]))

    qs, ks = qk_self
    qc, kc = qk_cross
    return (rows(desc, idx), (heads(qs, idx), heads(ks, idx)), (heads(qc, idx), heads(kc, idx_swap)),
            torch.gather(keep0, 1, i0), torch.gather(keep1, 1, i1),
            torch.gather(g0, 1, i0), torch.gather(g1, 1, i1))


def _scatter_matches(idx_local, ms_local, g0, g1, n_orig: int):
    """Slot-local matches back to original keypoint indexing
    (impx/models/fast.py:839)."""
    k = idx_local.shape[1]
    tgt = torch.where(idx_local >= 0, torch.gather(g1, 1, idx_local.clamp(0, k - 1)), -1)
    out_idx = torch.full((idx_local.shape[0], n_orig), -1, dtype=tgt.dtype, device=tgt.device)
    out_ms = torch.zeros((idx_local.shape[0], n_orig), dtype=ms_local.dtype, device=ms_local.device)
    return out_idx.scatter(1, g0, tgt), out_ms.scatter(1, g0, ms_local)


def forward_scan_eimp_compact(model, data: dict[str, Any], p: float = 0.2, mscore_th: float = 0.1,
                              uncertainty_ratio: float = 1.0, only_last: bool = False):
    """AdaGMN produce_matches with bucketed compaction
    (impx/models/fast.py:851): before each (iteration, bucket) point of
    config.compaction, the kept keypoints of both images are gathered into
    `bucket` slots, so attention and Sinkhorn shrink. After a gather the
    survivors are the whole tensor: InstanceNorm statistics and mass sums no
    longer see discarded keypoints (the reference's sliced evaluation). While
    nothing has been discarded before a gather, the result equals
    forward_scan_eimp's.

    Survivors beyond a bucket (the highest original indices) are dropped and
    counted: 'overflow0'/'overflow1' [B] hold each pair's total over all
    points; re-run overflowed pairs mask-only. Matches and the final
    'keep0'/'keep1' are in original indexing; 'scores' is [None]."""
    cfg = model.config
    if not cfg.compaction:
        raise ValueError("forward_scan_eimp_compact needs config.compaction")
    if model.seq_group is not None:
        raise ValueError("compaction gathers keypoints across the sequence blocks: under sequence "
                         "parallelism AdaGMN runs mask-only (forward_scan_eimp)")
    desc, valid0, valid1, b, n = _encode(model, data)
    starts = dict(compaction_schedule(cfg.compaction, cfg.n_layers, n=n))

    th = mscore_th * uncertainty_ratio
    g0 = torch.arange(n, device=desc.device).expand(b, n)
    g1 = g0
    overflow0 = torch.zeros((b,), dtype=torch.int32, device=desc.device)
    overflow1 = torch.zeros_like(overflow0)
    state = (desc, None, None, valid0, valid1, valid0, valid1)
    outs = []
    for i, do_pool in enumerate(_eimp_do_pool(cfg)):
        if i in starts:
            with span("impx.compact"):
                k = starts[i]
                desc, qk_self, qk_cross, keep0, keep1, _, _ = state
                overflow0 += (keep0.sum(dim=1) - k).clamp(min=0).to(torch.int32)
                overflow1 += (keep1.sum(dim=1) - k).clamp(min=0).to(torch.int32)
                desc, qk_self, qk_cross, keep0, keep1, g0, g1 = _compact_gather(
                    desc, qk_self, qk_cross, keep0, keep1, g0, g1, _stable_topk_indices(keep0, k),
                    _stable_topk_indices(keep1, k))
                state = (desc, qk_self, qk_cross, keep0, keep1, keep0, keep1)
        state, (idx0, ms0, *_) = _eimp_step(model, i, state, b, p, th, do_pool)
        if not only_last or i == cfg.n_layers - 1:
            with span("impx.compact"):
                outs.append(_scatter_matches(idx0, ms0, g0, g1, n))

    keep0, keep1 = state[3], state[4]
    none = torch.zeros((b, n), dtype=torch.bool, device=desc.device)
    return {"scores": [None], "indices0": [o[0] for o in outs], "mscores0": [o[1] for o in outs],
            "keep0": none.scatter(1, g0, keep0), "keep1": none.scatter(1, g1, keep1),
            "overflow0": overflow0, "overflow1": overflow1}


# ------------------------------------------------------------ EIMP training
EIMP_TRAIN_P, EIMP_TRAIN_TH = 0.2, 0.1  # impx's training matches and pooling threshold (fast.py:973)


def _eimp_train_step(model, i: int, do_pool: bool, state: tuple, b: int, gt, epi, terms: dict, counts=None):
    """Iteration i of EIMP training (the scan body of impx/models/fast.py:994).

    state = (desc, qk_self, qk_cross, keep0, keep1, full0, full1), as in
    `_eimp_step`: keys under the keep masks, queries and InstanceNorm under
    full0/full1. The two layers run on route A; the carried q/k of a shared
    layer takes gradient from both layers that use it. Then the supervised
    head of final projection i under the keep masks, against gt
    ([B, N+1, M+1] in the current indexing) restricted to the kept
    keypoints from first_it_to_update on, and its matches; on a pooling
    iteration, without gradient, the key masses of the layers' q/k and the
    pooling rule on the plan. counts: loss.loss_counts of gt under data
    parallelism (taken again for the restricted ground truth). Returns
    (state, terms, (indices0, mscores0))."""
    from impx_torch.models.adgm import _masked_gt

    cfg = model.config
    desc, qk_self, qk_cross, keep0, keep1, full0, full1 = state
    keep = torch.cat([keep0, keep1], dim=0)
    keep_swap = torch.cat([keep1, keep0], dim=0)
    full = torch.cat([full0, full1], dim=0)
    kw = dict(ac_fn=cfg.ac_fn, use_kernels=model.use_kernels)
    delta, qk_self = model.gnn[2 * i](desc, desc, qk_self, keep, full, **kw)
    desc = desc + delta
    delta, qk_cross = model.gnn[2 * i + 1](desc, _swap_half(desc), qk_cross, keep_swap, full, **kw)
    desc = desc + delta

    if i >= cfg.first_it_to_update:
        gt = _masked_gt(gt, keep0, keep1)
        counts = loss_counts(gt, model.data_group)
    t, score = supervised_head(model, desc[:b], desc[b:], i, gt, epi, keep0, keep1, counts)
    terms = {k: terms[k] + t[k] for k in terms}
    with torch.no_grad():
        idx0, _, ms0, _ = model.compute_matches(score, p=EIMP_TRAIN_P, valid0=keep0, valid1=keep1)
        if do_pool:
            masses = model._key_masses(qk_self, qk_cross, keep0, keep1, full0, full1)
            keep0, keep1 = model._pool_from_plan(score, masses, keep0, keep1, EIMP_TRAIN_TH, cfg.n_min_tokens)
    return (desc, qk_self, qk_cross, keep0, keep1, full0, full1), terms, (idx0, ms0)


def _mean_accuracy(accs: list) -> dict:
    """The accuracy counters averaged over the iterations (a linear map, so
    it takes data-parallel shares to shares)."""
    return {k: sum(a[k] for a in accs) / len(accs) for k in accs[0]}


def forward_train_scan_eimp(model, data: dict[str, Any]) -> dict[str, Any]:
    """AdaGMN's masked training forward on tensors already on the model's
    device (impx/models/fast.py:952): data as `forward_train_scan`'s.
    Returns the dict of `train_outputs`, whose accuracy counters are averaged
    over all iterations and whose matches0 and matching_scores0 are the last
    iteration's, in the keep masks of that iteration."""
    cfg = model.config
    gt = data["matching_mask"]
    epi = maybe_epipolar_matrix(model.whole_keypoints(data), cfg.geo_clamp) if cfg.with_geo else None
    counts = loss_counts(gt, model.data_group)
    n_pairs = None if counts is None else counts[0]
    desc, valid0, valid1, b, _ = _encode(model, data)
    state = (desc, None, None, valid0, valid1, model.seq_rows(valid0), model.seq_rows(valid1))
    terms, accs = zero_terms(epi is not None, desc.device), []
    for i, do_pool in enumerate(_eimp_do_pool(cfg)):
        state, terms, (idx0, ms0) = _eimp_train_step(model, i, do_pool, state, b, gt, epi, terms, counts)
        accs.append(matching_accuracy(idx0, gt, n_pairs=n_pairs))
    terms = {k: x / cfg.n_layers for k, x in terms.items()}
    return loss_outputs(cfg, terms, idx0, ms0, _mean_accuracy(accs))


def _gather_gt(gt, i0, i1):
    """The assignment mask [B, N+1, M+1] in the slots i0 [B, k] (rows) and
    i1 (columns), its dustbin row and column kept last
    (impx/models/fast.py:1095): the rows and columns of keypoints left out
    vanish, their matches no longer supervised."""
    b, n1, m1 = gt.shape
    rows = torch.cat([i0, torch.full((b, 1), n1 - 1, dtype=i0.dtype, device=i0.device)], dim=1)
    cols = torch.cat([i1, torch.full((b, 1), m1 - 1, dtype=i1.dtype, device=i1.device)], dim=1)
    g = torch.gather(gt, 1, rows[:, :, None].expand(-1, -1, m1))
    return torch.gather(g, 2, cols[:, None, :].expand(-1, rows.shape[1], -1))


def forward_train_scan_eimp_compact(model, data: dict[str, Any]) -> dict[str, Any]:
    """AdaGMN's training forward with bucketed compaction
    (impx/models/fast.py:1110): before each (iteration, bucket) point of
    config.train_compaction, the kept keypoints of both images, their q/k,
    the ground-truth mask and the epipolar matrix are gathered into `bucket`
    slots (`_compact_gather`, the port's corrected gather of the cross k);
    the gathered keypoints are then the queries and the norm's tokens, and
    the loss runs on the compacted plan. Each iteration's matches are
    scattered back to the original indexing and scored there against the
    full ground truth; the accuracy is their mean over all iterations.
    While nothing has been discarded before a gather the result equals
    `forward_train_scan_eimp`'s. Adds compaction_overflow0/1, the survivors
    dropped by full buckets, summed over the batch (fp32)."""
    cfg = model.config
    if model.seq_group is not None:
        raise ValueError("compaction gathers keypoints across the sequence blocks: under sequence "
                         "parallelism AdaGMN trains on the masked scan (forward_train_scan_eimp)")
    gt = data["matching_mask"].float()
    epi = maybe_epipolar_matrix(data, cfg.geo_clamp) if cfg.with_geo else None
    counts = loss_counts(gt, model.data_group)
    n_pairs = None if counts is None else counts[0]
    desc, valid0, valid1, b, n = _encode(model, data)
    starts = dict(compaction_schedule(cfg.train_compaction, cfg.n_layers, "train_compaction", n))
    g0 = g1 = torch.arange(n, device=desc.device).expand(b, n)
    overflow0 = torch.zeros((b,), dtype=torch.int32, device=desc.device)
    overflow1 = torch.zeros_like(overflow0)
    gt_seg, epi_seg = gt, epi
    state = (desc, None, None, valid0, valid1, valid0, valid1)
    terms, accs = zero_terms(epi is not None, desc.device), []
    for i, do_pool in enumerate(_eimp_do_pool(cfg)):
        if i in starts:
            k = starts[i]
            desc, qk_self, qk_cross, keep0, keep1, _, _ = state
            overflow0 += (keep0.sum(dim=1) - k).clamp(min=0).to(torch.int32)
            overflow1 += (keep1.sum(dim=1) - k).clamp(min=0).to(torch.int32)
            i0, i1 = _stable_topk_indices(keep0, k), _stable_topk_indices(keep1, k)
            desc, qk_self, qk_cross, keep0, keep1, g0, g1 = _compact_gather(
                desc, qk_self, qk_cross, keep0, keep1, g0, g1, i0, i1)
            gt_seg = _gather_gt(gt_seg, i0, i1)
            if epi_seg is not None:
                epi_seg = torch.gather(torch.gather(epi_seg, 1, i0[:, :, None].expand(-1, -1, epi_seg.shape[2])),
                                       2, i1[:, None, :].expand(-1, k, -1))
            state = (desc, qk_self, qk_cross, keep0, keep1, keep0, keep1)
        seg_counts = (counts if gt_seg is gt or i >= cfg.first_it_to_update
                      else loss_counts(gt_seg, model.data_group))
        state, terms, (idx0, ms0) = _eimp_train_step(model, i, do_pool, state, b, gt_seg, epi_seg, terms,
                                                     seg_counts)
        with torch.no_grad():
            idx0, ms0 = _scatter_matches(idx0, ms0, g0, g1, n)
            accs.append(matching_accuracy(idx0, gt, n_pairs=n_pairs))
    terms = {k: x / cfg.n_layers for k, x in terms.items()}
    out = loss_outputs(cfg, terms, idx0, ms0, _mean_accuracy(accs))
    out["compaction_overflow0"] = overflow0.sum().float()
    out["compaction_overflow1"] = overflow1.sum().float()
    return out
