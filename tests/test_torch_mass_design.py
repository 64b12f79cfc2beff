"""The bf16 design of kernel 6 (impx_torch/csrc/attention_mass.cu,
key_mass_bf16), emulated in plain PyTorch on the CPU.

The kernel takes each query row's log-sum-exp (kernel 4's lse, or its own
row-lse launch) and sums p = 2^(s c - lse log2 e), c = log2(e) / sqrt(dh), in
one pass. The product is transposed, S^T = K Q^T: a thread holds two keys'
scores against 16 of every 64 queries (columns 8j + 2t + e), sums them in
order into a tile's part and adds the part to a register sum. Two pairs of
warpgroups take alternate kept (head, 256-query tile) items, in order; each
pair's four threads of a key add their sums, (t0 + t1) + (t2 + t3), and
pair 1's sum is added to pair 0's. A query that weighs 0 takes lse = +inf,
so its p is 0 with no select; a tile with no kept query is skipped. With `splits` > 1 each split sums a contiguous range of the items
into its own row, and the rows are added in split order. Masked keys are written as 0; a batch with no valid key
(where kernel 4's lse is -1e30 and exp(s - lse) would be 1 a key) gets the
reference's H * (kept queries) / Nk on every key.

These tests settle that arithmetic before the kernel meets the card: against
the plain version `attention_key_mass_reference` and impx's Pallas kernel
in interpret mode, at chip_smoke.py's MASS_RTOL and MASS_ATOL; and the plain
version from lse, `attention_key_mass_from_lse_reference`, which the CPU
route of the wrapper takes when it is given lse."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import MASS_ATOL, MASS_RTOL
from impx.ops.pallas.attention import attention_key_mass as jax_key_mass
from impx_torch.ops.kernels.attention import (
    attention_key_mass, attention_key_mass_from_lse_reference, attention_key_mass_reference,
    mha_lse_reference)

TILE_Q = 256                    # queries a ring stage, as the kernel's kMassQ
PAIRS = 2                       # pairs of warpgroups that take turns, as kMassPairs
LOG2E = 1.4426950408889634

# (b, h, nq, nk, dh): ragged last query tiles (320, 100) and key blocks of
# 128 (300, 140, 77), one query tile exactly (256), dh 64, 32 and 16
CASES = [(3, 2, 320, 300, 64), (3, 3, 100, 140, 32), (3, 4, 256, 77, 16)]


def _inputs(b, h, nq, nk, dh, seed=0):
    """bf16 q, k, bool masks: batch 0's keys a padded prefix, batch 1's a
    scattered subset of a padded prefix (keypoints pooled away), the last
    batch's none; batch 0's queries a padded prefix whose second query tile
    keeps none (skipped), the others scattered."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(b, h, nq, dh).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rs.randn(b, h, nk, dh).astype(np.float32)).to(torch.bfloat16)
    key_mask = np.zeros((b, nk), bool)
    key_mask[0, :nk - 13] = True
    key_mask[1] = (np.arange(nk) < nk - 7) & (rs.rand(nk) > 0.5)
    query_mask = rs.rand(b, nq) > 0.3
    query_mask[0] = np.arange(nq) < min(nq, TILE_Q) - 9
    return q, k, torch.from_numpy(key_mask), torch.from_numpy(query_mask)


def _lse(q, k, key_mask):
    return mha_lse_reference(q, k, k, key_mask)[1]


def _f32(x):
    return float(np.float32(x))


def _emulate(q, k, key_mask, query_mask, lse, splits=1):
    """The kernel's arithmetic and summation order: [B, Nk] fp32."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    ntq = -(-nq // TILE_Q)
    c = _f32(_f32(1.0 / math.sqrt(dh)) * _f32(LOG2E))
    w = query_mask.bool()
    lse2 = torch.where(w[:, None, :], lse * _f32(LOG2E), math.inf)        # fp32 product
    lse2 = torch.nn.functional.pad(lse2, (0, ntq * TILE_Q - nq), value=math.inf)
    qp = torch.nn.functional.pad(q.float(), (0, 0, 0, ntq * TILE_Q - nq))   # TMA zero-fills
    st = torch.matmul(k.float(), qp.transpose(-1, -2))                     # S^T [b, h, nk, queries]
    arg = (st.double() * c - lse2[:, :, None, :].double()).float()          # one FFMA: one rounding
    p = torch.exp2(arg).view(b, h, nk, ntq, TILE_Q // 64, 8, 4, 2)         # tile, group, j, t, e
    part = torch.zeros((b, h, nk, ntq, 4))
    for group in range(TILE_Q // 64):
        for j in range(8):
            for e in range(2):
                part = part + p[..., group, j, :, e]
    kept_tile = w.view(b, 1, -1).new_zeros(b, ntq * TILE_Q)
    kept_tile[:, :nq] = w
    kept_tile = kept_tile.view(b, ntq, TILE_Q).any(dim=2)
    # a skipped tile adds exact zeros
    assert bool((part.permute(0, 3, 1, 2, 4)[~kept_tile] == 0).all())

    valid = key_mask.bool()
    all_masked = ~valid.any(dim=1)
    uniform = _f32(h) * w.sum(dim=1).float() / _f32(nk)
    items = h * ntq
    rows = []
    for s in range(splits):
        key_sum = torch.zeros((b, nk))
        for bi in range(b):
            kept_items = [i for i in range(s * items // splits, (s + 1) * items // splits)
                          if kept_tile[bi, i % ntq]]
            pair_sums = []
            for pair in range(PAIRS):
                acc = torch.zeros((nk, 4))
                for i in kept_items[pair::PAIRS]:
                    acc = acc + part[bi, i // ntq, :, i % ntq]
                pair_sums.append((acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3]))
            key_sum[bi] = sum(pair_sums[1:], pair_sums[0])
        out = torch.where(valid, key_sum, 0.0)
        rows.append(torch.where(all_masked[:, None], uniform[:, None] if s == 0 else 0.0, out))
    total = rows[0]
    for row in rows[1:]:
        total = total + row
    return total


def _impx(q, k, key_mask, query_mask):
    jq, jk = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k))
    return torch.from_numpy(np.array(jax_key_mass(jq, jk, jnp.asarray(key_mask.numpy()),
                                                  jnp.asarray(query_mask.numpy()), interpret=True)))


def _close(out, ref):
    torch.testing.assert_close(out, ref, rtol=MASS_RTOL, atol=MASS_ATOL)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_design_matches_plain_version_and_impx(b, h, nq, nk, dh, splits):
    """The schedule, at one split and at the compacted sizes' splits (8 is
    more splits than some cases have items: those splits sum nothing)."""
    q, k, key_mask, query_mask = _inputs(b, h, nq, nk, dh)
    out = _emulate(q, k, key_mask, query_mask, _lse(q, k, key_mask), splits)
    _close(out, attention_key_mass_reference(q, k, key_mask, query_mask))
    _close(out, _impx(q, k, key_mask, query_mask))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_from_lse_reference_matches_impx(b, h, nq, nk, dh, dtype):
    """The wrapper's CPU route with lse: the plain mass from
    `mha_lse_reference`'s lse against impx interpreted and the two-pass plain
    version."""
    q, k, key_mask, query_mask = _inputs(b, h, nq, nk, dh)
    q, k = q.to(dtype), k.to(dtype)
    lse = _lse(q, k, key_mask)
    out = attention_key_mass(q, k, key_mask, query_mask, lse)
    _close(out, attention_key_mass_from_lse_reference(q, k, key_mask, query_mask, lse))
    _close(out, attention_key_mass_reference(q, k, key_mask, query_mask))
    if dtype == torch.bfloat16:
        _close(out, _impx(q, k, key_mask, query_mask))


@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_fully_masked_batch_spreads_over_every_key(b, h, nq, nk, dh):
    """The batch with no valid key: lse is -1e30 exactly, exp(s - lse) is 1
    a key (Nk times the reference's 1/Nk), and the design writes H * (kept
    queries) / Nk on every key; masked keys of the other batches are 0."""
    q, k, key_mask, query_mask = _inputs(b, h, nq, nk, dh)
    lse = _lse(q, k, key_mask)
    assert bool((lse[-1] == -1e30).all())
    naive = torch.exp(torch.full((h, nq, nk), -1e30) - lse[-1][..., None])   # every score -1e30
    naive = torch.einsum("hqk,q->k", naive, query_mask[-1].float())
    out = _emulate(q, k, key_mask, query_mask, lse)
    want = h * query_mask[-1].sum().item() / nk
    torch.testing.assert_close(out[-1], torch.full((nk,), want), rtol=1e-6, atol=0.0)
    torch.testing.assert_close(naive, torch.full((nk,), want * nk))
    assert bool((out[:-1][~key_mask[:-1]] == 0).all())
    assert bool((out[:-1][key_mask[:-1]] > 0).all())


def test_plain_versions_agree_on_pooled_masks():
    """EIMP's shape of masks at a small size: keys pooled to a scattered
    subset, queries every real keypoint, the plain mass from lse and the
    two-pass plain version within the card's limits."""
    rs = np.random.RandomState(4)
    b, h, n, dh = 4, 4, 256, 64
    q, k = (torch.from_numpy(rs.randn(b, h, n, dh).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    real = torch.from_numpy(np.arange(n)[None] < rs.randint(n - 60, n + 1, (b, 1)))
    keep = real & torch.from_numpy(rs.rand(b, n) > 0.6)
    lse = _lse(q, k, keep)
    _close(attention_key_mass_from_lse_reference(q, k, keep, real, lse),
           attention_key_mass_reference(q, k, keep, real))
    _close(_emulate(q, k, keep, real, lse, splits=4), attention_key_mass_reference(q, k, keep, real))
