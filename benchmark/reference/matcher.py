"""The plain reference of IMP (DGNNS) and EIMP (AdaGMN with bucketed
compaction): inference matches and the training loss, in plain PyTorch.

Written from the published model (IMP, Xue et al., CVPR 2023,
github.com/feixue94/imp-release) as impx and impx_torch define its
numerics; it imports nothing of either and takes only the weights and the
inputs that the benchmark made. Each function works on a weight dict in
the matcher's state-dict layout (benchlib/weights.py) and on batches of
pairs with padded keypoint slots (valid0, valid1).

The layers: keypoint encoder MLP (3 -> 32 -> 64 -> 128 -> 256 -> 256) over
(x, y, score), added to the descriptors; per iteration a self and a cross
layer, each multi-head attention (heads split head-minor: channel
c = d * H + h), a merge, and the MLP (2D -> 2D -> D) over [x, message], whose
hidden block takes InstanceNorm (eps 1e-3) over the image's valid keypoints
and ReLU; a residual add. Layers that share attention (`sharing_layers`)
attend with the q, k of the previous layer of their kind and project only
v. The head: a per-iteration final projection, the scaled dot product, the
dustbin Sinkhorn (20 iterations, impx's marginals, u and v rounded to the
plan's storage dtype, bf16 when the (N+1) x (M+1) plan would pass 6 MiB in
fp32, as impx's kernel stores it) and mutual nearest neighbours above the
threshold. Masked keys take the finite -1e30, so a row with no valid key is
uniform.

Precision: every product runs through `Plain.mm`. `Plain()` is fp32 (the
caller keeps TF32 off); `Plain(bits=10)` rounds both operands of every
product to TF32's 10 mantissa bits first, which is what TF32 tensor cores
compute: the control that the comparison has to reject."""
from __future__ import annotations

import math

import torch

NEG = -1e30
NORM_EPS = 1e-3
SINK_EPS = 1e-8
LOG_EPS = 1e-8


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """fp32 x rounded to `bits` explicit mantissa bits, to nearest even."""
    shift = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    i = (i + ((1 << (shift - 1)) - 1) + ((i >> shift) & 1)) & ~((1 << shift) - 1)
    return i.view(torch.float32)


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with both operands rounded, and a backward whose products round
    theirs alike (the incoming gradient and the saved operands)."""

    @staticmethod
    def forward(ctx, a, b, bits: int):
        ra, rb = round_mantissa(a, bits), round_mantissa(b, bits)
        ctx.save_for_backward(ra, rb)
        ctx.bits = bits
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            ga, gb = torch.autograd.grad(torch.matmul(ra, rb), (ra, rb), round_mantissa(g, ctx.bits))
        return ga, gb, None


class Plain:
    def __init__(self, bits: int = 23):
        self.bits = bits

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.bits < 23:
            return _RoundedMatmul.apply(a, b, self.bits)
        return torch.matmul(a, b)


def sharing_layers(n_layers: int) -> list[bool]:
    """IMP's attention-sharing pattern, one entry a layer (2i: iteration i's
    self layer, 2i + 1 its cross layer): two iterations that recompute, then
    (recompute, recompute, share, share) over each two iterations."""
    pattern = [False, False] * 2 + [False, False, True, True] * 21
    return pattern[: 2 * n_layers]


def pooling_iterations(matcher: dict) -> list[bool]:
    """EIMP pools after the iterations whose self layer shares attention,
    from first_it_to_update on."""
    share = sharing_layers(matcher["n_layers"])
    return [share[2 * i] and i >= matcher["first_it_to_update"] for i in range(matcher["n_layers"])]


# ------------------------------------------------------------------ layers
def dense(P: Plain, W: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return P.mm(x, W[f"{name}.weight"]) + W[f"{name}.bias"]


def instance_norm(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[:, :, None].float()
    count = m.sum(dim=1, keepdim=True).clamp_min(1.0)
    mean = (x * m).sum(dim=1, keepdim=True) / count
    var = (((x - mean) ** 2) * m).sum(dim=1, keepdim=True) / count
    return (x - mean) * torch.rsqrt(var + NORM_EPS)


def mlp(P: Plain, W: dict, names: list[str], x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    for i, name in enumerate(names):
        x = dense(P, W, name, x)
        if i < len(names) - 1:
            x = torch.relu(instance_norm(x, mask))
    return x


def split_heads(y: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, D] -> [B, H, N, D / H], channel c = d * H + h."""
    b, n, d = y.shape
    return y.reshape(b, n, d // h, h).permute(0, 3, 1, 2)


def join_heads(o: torch.Tensor) -> torch.Tensor:
    b, h, n, dh = o.shape
    return o.permute(0, 2, 3, 1).reshape(b, n, dh * h)


def scores(P: Plain, q, k, key_mask) -> torch.Tensor:
    s = P.mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.where(key_mask[:, None, None, :], s, NEG)


def attention(P: Plain, q, k, v, key_mask) -> torch.Tensor:
    return P.mm(torch.softmax(scores(P, q, k, key_mask), dim=-1), v)


def layer(P: Plain, W: dict, li: int, shared: bool, heads: int, x, source, qk, key_mask, query_mask):
    """One attentional layer on x [B, N, D] attending to source; returns
    (x + delta, (q, k))."""
    pre = f"gnn.{li}"
    if shared:
        q, k = qk
        v = split_heads(dense(P, W, f"{pre}.proj", source), heads)
        merge = f"{pre}.merge"
    else:
        q = split_heads(dense(P, W, f"{pre}.attn.q", x), heads)
        k = split_heads(dense(P, W, f"{pre}.attn.k", source), heads)
        v = split_heads(dense(P, W, f"{pre}.attn.v", source), heads)
        merge = f"{pre}.attn.merge"
    message = dense(P, W, merge, join_heads(attention(P, q, k, v, key_mask)))
    delta = mlp(P, W, [f"{pre}.mlp.blocks.0", f"{pre}.mlp.blocks.1"], torch.cat([x, message], dim=-1), query_mask)
    return x + delta, (q, k)


def swap_half(x: torch.Tensor) -> torch.Tensor:
    b = x.shape[0] // 2
    return torch.cat([x[b:], x[:b]], dim=0)


def encode(P: Plain, W: dict, matcher: dict, data: dict) -> torch.Tensor:
    """Both images' descriptors plus their keypoint encoding, stacked [2B, N, D]."""
    names = [f"kenc.blocks.{i}" for i in range(len(matcher["keypoint_encoder"]) + 1)]
    out = []
    for i in (0, 1):
        x = torch.cat([data[f"norm_keypoints{i}"], data[f"scores{i}"][..., None]], dim=-1)
        out.append(data[f"descriptors{i}"] + mlp(P, W, names, x, data[f"valid{i}"]))
    return torch.cat(out, dim=0)


def distance(P: Plain, W: dict, i: int, d0, d1) -> torch.Tensor:
    p0, p1 = dense(P, W, f"final_proj.{i}", d0), dense(P, W, f"final_proj.{i}", d1)
    return P.mm(p0, p1.transpose(1, 2)) / math.sqrt(d0.shape[-1])


# -------------------------------------------------------------------- head
def plan_dtype(n: int, m: int) -> torch.dtype:
    """impx's storage rule for the [N+1, M+1] plan: fp32 up to 6 MiB."""
    up = lambda x, k: -(-x // k) * k  # noqa: E731
    return torch.float32 if up(n + 1, 16) * up(m + 1, 128) * 4 <= 6 * 1024 * 1024 else torch.bfloat16


def sinkhorn_stats(P: Plain, dist, bin_score, iterations: int, valid0, valid1) -> dict:
    """The dustbin Sinkhorn's u, v and the final plan's statistics: each
    row's max and argmax, each column's argmax, row and column masses of the
    interior (impx's kernel, step for step)."""
    b, n, m = dist.shape
    f0, f1 = valid0.float(), valid1.float()
    r = torch.cat([f0, f0.sum(1, keepdim=True) + 1.0], dim=1)
    c = torch.cat([f1, f1.sum(1, keepdim=True) + 1.0], dim=1)
    ok = valid0[:, :, None] & valid1[:, None, :]
    s = torch.where(ok, dist.float(), NEG)
    p = torch.softmax(torch.cat([s, bin_score.float().expand(b, n, 1)], dim=2), dim=2)
    inv = 1.0 / c[:, m:]
    p = torch.cat([p, torch.cat([torch.where(valid1, inv, 0.0), inv], dim=1)[:, None, :]], dim=1)
    pd = plan_dtype(n, m)
    p_loop = p.to(pd).float()
    u, v = torch.ones_like(r), torch.ones_like(c)
    for _ in range(iterations):
        u = r / (P.mm(p_loop, v.to(pd).float()[:, :, None])[:, :, 0] + SINK_EPS)
        v = c / (P.mm(u.to(pd).float()[:, None, :], p_loop)[:, 0, :] + SINK_EPS)
    val = p_loop[:, :n, :m] * u[:, :n, None] * v[:, None, :m]
    filled = torch.where(ok, val, -1.0)
    inner = torch.where(ok, val, 0.0)
    return {"max0": filled.amax(2), "idx0": filled.argmax(2), "idx1": filled.argmax(1),
            "rowmass": inner.sum(2), "colmass": inner.sum(1)}


def mutual_matches(max0, idx0, idx1, p: float, valid0, valid1):
    """indices0 (-1: unmatched) and mscores0 from the plan's statistics."""
    n, m = idx0.shape[1], idx1.shape[1]
    mutual0 = torch.arange(n, device=idx0.device)[None] == torch.gather(idx1, 1, idx0)
    ms0 = torch.where(mutual0, max0, 0.0)
    ok0 = mutual0 & (ms0 > p) & valid0
    return torch.where(ok0, idx0, -1), ms0


def match_head(P: Plain, W: dict, matcher: dict, i: int, desc, b: int, valid0, valid1, p: float):
    dist = distance(P, W, i, desc[:b], desc[b:])
    st = sinkhorn_stats(P, dist, W["bin_score"], matcher["sinkhorn_iterations"], valid0, valid1)
    idx0, ms0 = mutual_matches(st["max0"], st["idx0"], st["idx1"], p, valid0, valid1)
    return idx0, ms0, st


# ------------------------------------------------------------------- IMP
def imp_matches(P: Plain, W: dict, matcher: dict, data: dict) -> dict:
    """IMP's last-iteration matches of a batch: indices0 [B, N], mscores0."""
    valid0, valid1 = data["valid0"], data["valid1"]
    b, h = valid0.shape[0], matcher["num_heads"]
    desc = encode(P, W, matcher, data)
    mask, mask_swap = torch.cat([valid0, valid1]), torch.cat([valid1, valid0])
    share = sharing_layers(matcher["n_layers"])
    qk_self = qk_cross = None
    for i in range(matcher["n_layers"]):
        desc, qk_self = layer(P, W, 2 * i, share[2 * i], h, desc, desc, qk_self, mask, mask)
        desc, qk_cross = layer(P, W, 2 * i + 1, share[2 * i + 1], h, desc, swap_half(desc), qk_cross,
                               mask_swap, mask)
    idx0, ms0, _ = match_head(P, W, matcher, matcher["n_layers"] - 1, desc, b, valid0, valid1,
                              matcher["match_threshold"])
    return {"indices0": idx0, "mscores0": ms0}


# ------------------------------------------------------------------ EIMP
def key_mass(P: Plain, q, k, key_mask, query_mask) -> torch.Tensor:
    """Each key's attention probability summed over heads and the queries of
    query_mask [B, Nk]."""
    prob = torch.softmax(scores(P, q, k, key_mask), dim=-1)
    return P.mm(query_mask.float()[:, None, None, :], prob)[:, :, 0, :].sum(1)


def normalise(mass: torch.Tensor) -> torch.Tensor:
    return mass / (mass.sum(dim=1, keepdim=True) + 1e-15)


def masked_median(values, mask):
    """The lower median of values[mask] per row; +inf for an empty row."""
    srt = torch.sort(torch.where(mask, values, torch.inf), dim=1).values
    k = ((mask.sum(1) - 1) // 2).clamp(0, values.shape[1] - 1)
    return torch.gather(srt, 1, k[:, None])[:, 0]


def pool(rowmass, colmass, masses, keep0, keep1, th: float, n_min: int):
    """EIMP's pooling rule: a keypoint stays if its plan mass reaches th, or
    if either of its attention masses reaches the median over the keypoints
    that pass th; an image never pools at n_min kept keypoints or fewer."""
    n00, n01, n11, n10 = masses

    def side(keep, pids, a, c):
        aug = (a >= masked_median(a, pids)[:, None]) | (c >= masked_median(c, pids)[:, None])
        update = pids.any(1, keepdim=True) & (keep.sum(1, keepdim=True) > n_min)
        return torch.where(update, keep & (pids | aug), keep)

    return side(keep0, (rowmass >= th) & keep0, n00, n01), side(keep1, (colmass >= th) & keep1, n11, n10)


def first_slots(keep: torch.Tensor, k: int) -> torch.Tensor:
    """The first k slots of each row, kept keypoints first, each group in order."""
    return torch.sort(keep.to(torch.uint8), dim=1, descending=True, stable=True).indices[:, :k]


def eimp_matches(P: Plain, W: dict, matcher: dict, data: dict, mscore_th: float = 0.1) -> dict:
    """EIMP with bucketed compaction: indices0 and mscores0 of the last
    iteration and the final keep0, keep1 in the original slots, and
    overflow0, overflow1 (kept keypoints a bucket had no slot for). Before
    a gather, queries and the norms see every valid keypoint and keys the
    kept ones; after it, the gathered slots are the whole image."""
    valid0, valid1 = data["valid0"], data["valid1"]
    b, n = valid0.shape
    h = matcher["num_heads"]
    share = sharing_layers(matcher["n_layers"])
    starts = {int(it): int(k) for it, k in matcher["compaction"]}
    desc = encode(P, W, matcher, data)
    keep0, keep1, full0, full1 = valid0, valid1, valid0, valid1
    g0 = g1 = torch.arange(n, device=desc.device).expand(b, n)
    over0 = torch.zeros(b, dtype=torch.long, device=desc.device)
    over1 = torch.zeros_like(over0)
    qk_self = qk_cross = None
    for i, do_pool in enumerate(pooling_iterations(matcher)):
        if i in starts:
            k = starts[i]
            over0 += (keep0.sum(1) - k).clamp(min=0)
            over1 += (keep1.sum(1) - k).clamp(min=0)
            i0, i1 = first_slots(keep0, k), first_slots(keep1, k)
            idx, idx_swap = torch.cat([i0, i1]), torch.cat([i1, i0])
            rows = lambda t, j: torch.gather(t, 1, j[:, :, None].expand(-1, -1, t.shape[2]))  # noqa: E731
            hd = lambda t, j: torch.gather(t, 2, j[:, None, :, None].expand(-1, t.shape[1], -1, t.shape[3]))  # noqa: E731
            desc = rows(desc, idx)
            qk_self = (hd(qk_self[0], idx), hd(qk_self[1], idx))
            qk_cross = (hd(qk_cross[0], idx), hd(qk_cross[1], idx_swap))   # the cross keys are the other image's
            keep0, keep1 = torch.gather(keep0, 1, i0), torch.gather(keep1, 1, i1)
            g0, g1 = torch.gather(g0, 1, i0), torch.gather(g1, 1, i1)
            full0, full1 = keep0, keep1
        keep, keep_swap, full = torch.cat([keep0, keep1]), torch.cat([keep1, keep0]), torch.cat([full0, full1])
        desc, qk_self = layer(P, W, 2 * i, share[2 * i], h, desc, desc, qk_self, keep, full)
        desc, qk_cross = layer(P, W, 2 * i + 1, share[2 * i + 1], h, desc, swap_half(desc), qk_cross, keep_swap,
                               full)
        idx0, ms0, st = match_head(P, W, matcher, i, desc, b, keep0, keep1, matcher["match_threshold"])
        if do_pool:
            m_self = key_mass(P, *qk_self, keep, full)
            m_cross = key_mass(P, *qk_cross, keep_swap, full)
            masses = (normalise(m_self[:b]), normalise(m_cross[b:]), normalise(m_self[b:]), normalise(m_cross[:b]))
            keep0, keep1 = pool(st["rowmass"], st["colmass"], masses, keep0, keep1, mscore_th,
                                matcher["n_min_tokens"])
    k = idx0.shape[1]
    target = torch.where(idx0 >= 0, torch.gather(g1, 1, idx0.clamp(0, k - 1)), -1)
    none = torch.zeros((b, n), dtype=torch.bool, device=desc.device)
    return {"indices0": torch.full((b, n), -1, dtype=torch.long, device=desc.device).scatter(1, g0, target),
            "mscores0": torch.zeros((b, n), device=desc.device).scatter(1, g0, ms0),
            "keep0": none.scatter(1, g0, keep0), "keep1": none.scatter(1, g1, keep1),
            "overflow0": over0, "overflow1": over1}


# ---------------------------------------------------------------- training
def sinkhorn_plan(P: Plain, dist, bin_score, iterations: int, valid0, valid1) -> torch.Tensor:
    """The differentiable dustbin plan [B, N+1, M+1] of training (fp32)."""
    b, n, m = dist.shape
    f0, f1 = valid0.float(), valid1.float()
    r = torch.cat([f0, f0.sum(1, keepdim=True) + 1.0], dim=1)
    c = torch.cat([f1, f1.sum(1, keepdim=True) + 1.0], dim=1)
    one = torch.ones((b, 1), dtype=torch.bool, device=dist.device)
    v0p, v1p = torch.cat([valid0, one], 1), torch.cat([valid1, one], 1)
    padded = torch.cat([torch.cat([dist, bin_score.expand(b, n, 1)], 2), bin_score.expand(b, 1, m + 1)], 1)
    p = torch.softmax(torch.where(v0p[:, :, None] & v1p[:, None, :], padded, NEG), dim=-1)
    u, v = torch.ones_like(r), torch.ones_like(c)
    for _ in range(iterations):
        u = r / (P.mm(p, v[:, :, None])[:, :, 0] + SINK_EPS)
        v = c / (P.mm(u[:, None, :], p)[:, 0, :] + SINK_EPS)
    return p * u[:, :, None] * v[:, None, :]


def graph_loss(plan, gt) -> torch.Tensor:
    """IMP's matching loss: the mean NLL of the true correspondences of each
    pair, plus half the mean NLL of the dustbin assignments of unmatched
    keypoints in each image (pairs that have some)."""
    log_p = torch.log(plan.abs() + LOG_EPS)
    num_corr = gt[:, :-1, :-1].sum((1, 2))
    num_corr = torch.where(num_corr == 0, 1.0, num_corr)
    corr = -((log_p[:, :-1, :-1] * gt[:, :-1, :-1]).sum((1, 2)) / num_corr).mean()
    n1, n2 = gt[:, :, -1].sum(1), gt[:, -1, :].sum(1)
    m1, m2 = n1 > 0, n2 > 0
    l1, l2 = (log_p[:, :, -1] * gt[:, :, -1]).sum(1), (log_p[:, -1, :] * gt[:, -1, :]).sum(1)
    mean1 = torch.where(m1, l1 / torch.where(m1, n1, 1.0), 0.0).sum() / m1.sum().clamp_min(1)
    mean2 = torch.where(m2, l2 / torch.where(m2, n2, 1.0), 0.0).sum() / m2.sum().clamp_min(1)
    incorr = torch.where(m1.any(), -(mean1 + mean2) / 2.0, 0.0)
    return corr + incorr


def train_loss(P: Plain, W: dict, matcher: dict, batch: dict) -> torch.Tensor:
    """IMP's training loss over every iteration (supervision 'all'): the
    graph loss of each iteration's plan, meaned over the iterations. Each
    iteration is checkpointed (recomputed in the backward), so that the
    reference's memory holds one iteration's activations at a time."""
    from torch.utils.checkpoint import checkpoint

    valid0, valid1 = batch["valid0"], batch["valid1"]
    b, h = valid0.shape[0], matcher["num_heads"]
    gt = batch["matching_mask"].float()
    mask, mask_swap = torch.cat([valid0, valid1]), torch.cat([valid1, valid0])
    share = sharing_layers(matcher["n_layers"])

    def iteration(i, desc, qk_self, qk_cross):
        desc, qk_self = layer(P, W, 2 * i, share[2 * i], h, desc, desc, qk_self, mask, mask)
        desc, qk_cross = layer(P, W, 2 * i + 1, share[2 * i + 1], h, desc, swap_half(desc), qk_cross,
                               mask_swap, mask)
        plan = sinkhorn_plan(P, distance(P, W, i, desc[:b], desc[b:]), W["bin_score"],
                             matcher["sinkhorn_iterations"], valid0, valid1)
        return desc, qk_self, qk_cross, graph_loss(plan, gt)

    desc = encode(P, W, matcher, batch)
    qk_self = qk_cross = None
    total = 0.0
    for i in range(matcher["n_layers"]):
        desc, qk_self, qk_cross, loss = checkpoint(iteration, i, desc, qk_self, qk_cross, use_reentrant=False)
        total = total + loss
    return total / matcher["n_layers"]


class plain_fp32:
    """TF32 off for the reference's products (the configuration's fp32)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_steps(P: Plain, W: dict, matcher: dict, batches: list, lr: float) -> dict:
    """Plain Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction) from the weights W over `batches`, one step each. Returns
    each step's loss, the first step's gradient and the weights after the
    last step."""
    params = {k: t.detach().clone().requires_grad_(True) for k, t in W.items()}
    mu = {k: torch.zeros_like(t) for k, t in params.items()}
    nu = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        loss = train_loss(P, params, matcher, batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(loss.item())
        with torch.no_grad():
            grads = {k: torch.zeros_like(t) if g is None else g for (k, t), g in zip(params.items(), grads)}
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in grads.items()}
            if not math.isfinite(losses[-1]):
                continue
            for k, t in params.items():
                mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * grads[k]
                nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * grads[k] * grads[k]
                m_hat = mu[k] / (1 - ADAM_B1 ** step)
                v_hat = nu[k] / (1 - ADAM_B2 ** step)
                t -= lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    return {"losses": losses, "first_grad": first_grad, "params": {k: t.detach() for k, t in params.items()}}
