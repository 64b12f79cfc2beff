"""Kernel 3's tensor-core design (impx_torch/csrc/attention_bwd.cu), emulated
in plain PyTorch on the CPU against its plain version `mha_bwd_reference`.

The bf16 kernel finds each query row's max m, sum l and delta in one pass
over 64-key tiles: D = sum_j dp_j exp(s_j - m) is rescaled by exp(m_old -
m_new) as m grows, exactly as l is, and delta = D / l. The products dq =
ds k, dk = ds^T q and dv = p^T do have one fp32 factor (ds or p); the
kernel splits it into hi = bf16(x) and lo = bf16(x - hi) and issues two
bf16 products with fp32 accumulation, which keeps about 16 bits of each
fp32 factor (2^-17 relative a term). These tests settle those numerics
before the kernel runs on a card: the online delta is the two-pass delta to
fp32 rounding, the split products sit far inside the card tests' limit
(`BWD_REL_L2`), and a design without the lo half would not."""
import numpy as np
import pytest
import torch

from impx_torch.ops.kernels.attention import NEG, mha_bwd_reference

from test_torch_kernels import BWD_REL_L2, _rel_l2_per_batch

TILE = 64      # keys a tile, as the kernel's kBlock
LIMIT = BWD_REL_L2[torch.bfloat16]

# (b, h, nq, nk, dh): the first as small as the design allows to show a
# ragged second tile; the others reach dh 16 and 64 and several tiles
CASES = [(2, 2, 96, 96, 32), (3, 2, 70, 130, 16), (2, 2, 65, 200, 64)]


def _inputs(b, h, nq, nk, dh, seed=0):
    """bf16 q, k, v, do; batch 0 with 20 padded keys, the middle batches a
    random mask, the last batch fully masked."""
    rs = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rs.randn(b, h, nq, dh).astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(b, h, nk, dh).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    mask = torch.from_numpy(rs.rand(b, nk) > 0.3)
    mask[0] = torch.arange(nk) < nk - 20
    mask[-1] = False
    return q, k, v, mask, do


def _scores_and_dp(q, k, v, mask, do):
    """fp32 scaled, masked scores and dp = do v^T: the kernel's bf16 products
    with fp32 accumulation (products of bf16 values are exact in fp32)."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(mask[:, None, None, :], s, torch.tensor(NEG))
    return s, torch.matmul(do.float(), v.float().transpose(-1, -2))


def _online_stats(s, dp):
    """The dq launch's first pass: (m, l, delta) from 64-key tiles."""
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    l, d = torch.zeros_like(m), torch.zeros_like(m)
    for k0 in range(0, s.shape[-1], TILE):
        st, dpt = s[..., k0:k0 + TILE], dp[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        e, a = torch.exp(st - m_new), torch.exp(m - m_new)   # a = 0 on the first tile
        l = l * a + e.sum(dim=-1, keepdim=True)
        d = d * a + (dpt * e).sum(dim=-1, keepdim=True)
        m = m_new
    return m, l, d / l


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate(q, k, v, mask, do, lo_half=True):
    """Kernel 3's bf16 design: (dq, dk, dv) in fp32, before the output's
    rounding. lo_half=False rounds p and ds to bf16 once instead."""
    scale = q.shape[-1] ** -0.5
    s, dp = _scores_and_dp(q, k, v, mask, do)
    m, l, delta = _online_stats(s, dp)
    p = torch.exp(s - m) * (1 / l)      # the kernel's reciprocal, taken once a row
    ds = p * (dp - delta) * scale
    kf, qf, dof = k.float(), q.float(), do.float()
    parts = (_split(ds), _split(p)) if lo_half else (
        (ds.to(torch.bfloat16).float(),), (p.to(torch.bfloat16).float(),))
    dq = sum(torch.matmul(x, kf) for x in parts[0])
    dk = sum(torch.matmul(x.transpose(-1, -2), qf) for x in parts[0])
    dv = sum(torch.matmul(x.transpose(-1, -2), dof) for x in parts[1])
    return dq, dk, dv


@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_online_delta_equals_two_pass_delta(b, h, nq, nk, dh):
    """delta from the one-pass (m, l, D) recurrence against the plain
    version's two passes (max and sum, then sum_j dp_j p_j): equal to fp32
    rounding of the sums, |difference| <= 1e-6 times sum_j |dp_j| p_j, the
    size of the terms (read at most 1.6e-7 of it). A fully masked row
    gets m = -1e30 and l = Nk exactly, so p = 1/Nk."""
    q, k, v, mask, do = _inputs(b, h, nq, nk, dh)
    s, dp = _scores_and_dp(q, k, v, mask, do)
    m, l, delta = _online_stats(s, dp)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    two_pass = (dp * p).sum(dim=-1, keepdim=True)
    size = (dp.abs() * p).sum(dim=-1, keepdim=True)
    assert bool(((delta - two_pass).abs() <= 1e-6 * size).all())
    assert bool((m[-1] == NEG).all()) and bool((l[-1] == nk).all())
    assert bool((torch.exp(s[-1] - m[-1]) / l[-1] == torch.tensor(1.0 / nk)).all())


@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_split_products_before_rounding_sit_far_inside_the_limit(b, h, nq, nk, dh):
    """The design's own error: its fp32 dq, dk, dv against the plain version
    in fp32 on the same (bf16-valued) inputs, each batch by relative L2,
    under LIMIT / 100 (read about 2.5e-6: the lo half's rounding, 2^-18 of
    each term at most)."""
    q, k, v, mask, do = _inputs(b, h, nq, nk, dh)
    ref = mha_bwd_reference(q.float(), k.float(), v.float(), mask, do.float())
    for name, a, r in zip(("dq", "dk", "dv"), _emulate(q, k, v, mask, do), ref):
        rel = _rel_l2_per_batch(a, r)
        assert bool((rel <= LIMIT / 100).all()), (name, rel.tolist())


@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_split_products_in_bf16_sit_inside_the_limit(b, h, nq, nk, dh):
    """In the stream dtype, as the card tests compare: both sides round dq,
    dk and dv to bf16 once, so the fp32 difference above flips a last bit now
    and then: read 2e-6 to 2.6e-4 a batch (the most at dh = 16, where a
    batch has the fewest elements), held under LIMIT / 2. A design that
    rounds p and ds to bf16 once (no lo half) reads about 2.5e-3, beyond
    LIMIT: the card tests' limit tells the two apart."""
    q, k, v, mask, do = _inputs(b, h, nq, nk, dh)
    ref = mha_bwd_reference(q, k, v, mask, do)
    split = _emulate(q, k, v, mask, do)
    once = _emulate(q, k, v, mask, do, lo_half=False)
    for name, a, a_once, r in zip(("dq", "dk", "dv"), split, once, ref):
        rel = _rel_l2_per_batch(a.to(torch.bfloat16), r)
        rel_once = _rel_l2_per_batch(a_once.to(torch.bfloat16), r)
        assert bool((rel <= LIMIT / 2).all()), (name, rel.tolist())
        assert rel_once.max().item() > LIMIT, (name, rel_once.tolist())
