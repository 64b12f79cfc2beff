"""The work that a matcher's inputs need, counted from the configuration and
each pair's valid keypoints: the model's products (for `mfu`), the
attention's products and bytes (the attention rooflines) and the Sinkhorn
head's (its roofline). Products count 2 flops a multiply-add. Only valid
keypoints count: padded slots and masked keys need no work.

EIMP with bucketed compaction is counted at its buckets: from each
(iteration, bucket) of the schedule on, an image holds at most `bucket`
keypoints. Pooling may keep fewer, which the inputs alone do not tell, so
the count is the most these inputs can need there, never more than the
program computes."""
from __future__ import annotations

from reference.matcher import sharing_layers


def tokens_per_iteration(matcher: dict, n0: int, n1: int) -> list[tuple[int, int]]:
    """(keypoints of image 0, of image 1) that iteration i works on."""
    starts = {int(it): int(k) for it, k in matcher.get("compaction", ())}
    out, a0, a1 = [], n0, n1
    for i in range(matcher["n_layers"]):
        if i in starts:
            a0, a1 = min(a0, starts[i]), min(a1, starts[i])
        out.append((a0, a1))
    return out


def encoder_flops(matcher: dict, n: int) -> float:
    chans = [3, *matcher["keypoint_encoder"], matcher["descriptor_dim"]]
    return 2.0 * n * sum(a * b for a, b in zip(chans[:-1], chans[1:]))


def attention_pairs(matcher: dict, n0: int, n1: int) -> list[float]:
    """(query, key) pairs of each attention layer, both images together."""
    out = []
    for a0, a1 in tokens_per_iteration(matcher, n0, n1):
        out += [float(a0 * a0 + a1 * a1), float(2 * a0 * a1)]   # self, cross
    return out


def head_flops(matcher: dict, a0: int, a1: int) -> float:
    """One score head: the final projection of both images, the distance,
    and the Sinkhorn iterations over the dustbin-padded plan (2 flops a cell
    in each of the 2 * iterations passes, plus its softmax and statistics)."""
    d = matcher["descriptor_dim"]
    cells = (a0 + 1) * (a1 + 1)
    return 2.0 * d * d * (a0 + a1) + 2.0 * d * a0 * a1 + cells * (4.0 * matcher["sinkhorn_iterations"] + 7)


def forward_flops(matcher: dict, n0: int, n1: int, head_every_iteration: bool) -> float:
    """The products of one pair's forward: keypoint encoder, every layer's
    projections, attention, merge and MLP, and the score head after the
    last iteration or, with head_every_iteration, after each."""
    d = matcher["descriptor_dim"]
    shared = sharing_layers(matcher["n_layers"])
    its = tokens_per_iteration(matcher, n0, n1)
    total = encoder_flops(matcher, n0) + encoder_flops(matcher, n1)
    pairs = attention_pairs(matcher, n0, n1)
    for layer, share in enumerate(shared):
        a0, a1 = its[layer // 2]
        macs_a_token = (2 if share else 4) * d * d + 6 * d * d   # projections, merge, MLP (2d->2d->d)
        total += 2.0 * macs_a_token * (a0 + a1) + 4.0 * d * pairs[layer]
    for i, (a0, a1) in enumerate(its):
        if head_every_iteration or i == len(its) - 1:
            total += head_flops(matcher, a0, a1)
    return total


def attention_forward_work(matcher: dict, n0: int, n1: int) -> tuple[float, float]:
    """(flops, bytes) of every attention forward of one pair: QK^T and P.V
    over the valid pairs; q and o of the queries, k and v of the keys, fp32
    or bf16 by the compute dtype."""
    d = matcher["descriptor_dim"]
    size = 2 if matcher["compute_dtype"] == "bfloat16" else 4
    flops = sum(4.0 * d * p for p in attention_pairs(matcher, n0, n1))
    nbytes = 0.0
    for a0, a1 in tokens_per_iteration(matcher, n0, n1):
        nbytes += 2 * (4.0 * d * size * (a0 + a1))    # self and cross: q, o, k, v of both images
    return flops, nbytes


def attention_backward_work(matcher: dict, n0: int, n1: int) -> tuple[float, float]:
    """(flops, bytes) of every attention backward of one pair (the kernel that
    recomputes the softmax): QK^T, dP = dO V^T, dV, dQ and dK over the valid
    pairs (10 flops a pair and channel); q, k, v, dO read and dq, dk, dv
    written."""
    d = matcher["descriptor_dim"]
    size = 2 if matcher["compute_dtype"] == "bfloat16" else 4
    flops = sum(10.0 * d * p for p in attention_pairs(matcher, n0, n1))
    nbytes = 0.0
    for a0, a1 in tokens_per_iteration(matcher, n0, n1):
        nbytes += 2 * (7.0 * d * size * (a0 + a1))
    return flops, nbytes


def sinkhorn_work(matcher: dict, n0: int, n1: int, every_iteration: bool) -> tuple[float, float]:
    """(flops, bytes) of the Sinkhorn heads of one pair: the iterations'
    products and the statistics over the valid (N+1) x (M+1) block, against
    reading the valid cells of the distance once and writing u, v and the
    row and column statistics (fp32)."""
    its = tokens_per_iteration(matcher, n0, n1)
    flops = nbytes = 0.0
    for i, (a0, a1) in enumerate(its):
        if every_iteration or i == len(its) - 1:
            flops += (a0 + 1) * (a1 + 1) * (4.0 * matcher["sinkhorn_iterations"] + 7)
            nbytes += 4.0 * (a0 * a1 + 4 * (a0 + a1 + 2))
    return flops, nbytes
