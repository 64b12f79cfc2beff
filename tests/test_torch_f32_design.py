"""The fp32 design of kernels 1, 4 and 6 on Hopper's tensor cores
(impx_torch/csrc/attention_tf32.cuh, attn_fwd_tf32x3, and
impx_torch/csrc/attention_mass.cu, key_mass_tf32x3), emulated in plain
PyTorch on the CPU.

Every product runs in 3xTF32 on wgmma m64nNk8: each fp32 operand splits as
hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away from zero, as
cvt.rna, which the kernels do in integer arithmetic on the bits and this file
on the int32 view), and each 8-deep k-step adds lo.hi, then hi.lo, then
hi.hi to the fp32 accumulator, each product one rounding of its exact 8-term
sum: to nearest, or toward zero, as NVIDIA's tensor cores were measured to
round their fp32 accumulation (Fasi, Higham, Mikaitis and Pranesh, PeerJ CS
2021: V100, T4, A100), a model of the card that its readings decide. The
forward walks 64-key tiles with the bf16 kernel's
base-2 online softmax (p = 2^(s c - m c), c = log2(e) / sqrt(dh), one FFMA a
score), P unrounded and split for P.V into an accumulator that starts from
zero each tile, then O = O alpha + that in one fp32 FFMA (the walk "tile");
before, every tile's P.V ran on in O's own accumulator, rescaled by alpha
first (the walk "chain"), whose error under toward-zero rounding grows with
the key count. lse = m / sqrt(dh) + log(l), -1e30 on
a batch with no valid key. Without P.V the same pass is the mass's standalone
row lse, so both routes of the mass take the same lse. The mass sums p =
2^(s c - lse log2 e) over S^T = K Q^T in 64-query tiles, each thread over its
16 of every 64 queries, the kept (head, tile) items of a split in order, the
four threads of a key (t0 + t1) + (t2 + t3), the splits' rows in order. The
exponentials are exact here (the card's ex2.approx is within 2^-22).

These tests settle that arithmetic before the kernels meet the card: against
the plain versions and impx's Pallas kernels in interpret mode, at the card's
fp32 limits (chip_smoke.py's ATTN_TOL, FWD_LSE_TOL, MASS_RTOL, MASS_ATOL);
one TF32 pass, without the lo terms, misses ATTN_TOL; under toward-zero
accumulation the chained walk misses FWD_O_REL_L2 at 2048 keys against
float64, which the tile walk meets at 2048 and 4096. They also hold the
plain versions to impx on a float key mask with negative entries, which
impx reads as `> 0`."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_TOL, FWD_LSE_TOL, FWD_O_REL_L2, MASS_ATOL, MASS_RTOL
from impx.ops.pallas.attention import attention_key_mass as jax_key_mass
from impx.ops.pallas.attention import mha_fused_lse as jax_mha_fused_lse
from impx_torch.ops.kernels.attention import (
    NEG, attention_key_mass_from_lse_reference, attention_key_mass_reference, mha_lse_reference,
    mha_reference)

TILE_K = 64                    # keys a forward tile, as kF32TileK
TILE_Q = 64                    # queries a mass ring stage, as kF32MassQ
STEP = 8                       # the k depth of a tf32 wgmma
LOG2E = 1.4426950408889634
TOL = ATTN_TOL[torch.float32]
REL_L2 = FWD_O_REL_L2[torch.float32]

# (b, h, nq, nk, dh): ragged last key tiles (150, 77, 5), Nq not a multiple
# of the 128 query rows of a block (200, 100, 17, 130), a multiple of the key
# tile (256), dh 64, 32 and 16
FWD_CASES = [(3, 2, 200, 150, 64), (3, 2, 100, 77, 32), (3, 2, 17, 5, 16), (3, 2, 130, 256, 32)]
# (b, h, nq, nk, dh): ragged 64-query tiles (100, 130) and 128-key CTAs (300,
# 140, 77), whole tiles (320)
MASS_CASES = [(3, 2, 320, 300, 64), (3, 3, 100, 140, 32), (3, 4, 130, 77, 16)]
# (b, h, nq, dh) and the long key walks of the card's accuracy checks
LONG = (1, 2, 64, 64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulations' many small ops cost more in thread hand-offs than in
    arithmetic on a shared host: run this module on one thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _f32(x):
    return float(np.float32(x))


def tf32(x):
    """The kernels' to_tf32 (cvt.rna.tf32.f32's rounding): add half of the 13
    dropped bits' unit to the magnitude (the low 31 bits of a float's int32
    view), then clear them: round to nearest, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def to_f32(x, rounding):
    """float64 x to fp32, to nearest or toward zero (rounded to nearest, then
    one ulp back toward zero where that overshot)."""
    r = x.float()
    if rounding == "zero":
        r = torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def mma(acc, a, b, passes=3, rounding="nearest"):
    """acc [..., M, N] fp32 += a [..., M, K] b [..., K, N], 8 of K a k-step:
    lo.hi, hi.lo, hi.hi (passes=3), or hi.hi alone (one TF32 pass); each
    k-step's sum with the accumulator rounded to nearest or toward zero."""
    ah, al = split(a)
    bh, bl = split(b)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for k0 in range(0, a.shape[-1], STEP):
        for x, y in terms:
            step = x[..., k0:k0 + STEP].double() @ y[..., k0:k0 + STEP, :].double()
            acc = to_f32(acc.double() + step, rounding)
    return acc


def emulate_forward(q, k, v, mask, passes=3, with_pv=True, walk="tile", rounding="nearest"):
    """Kernels 1 and 4 (with_pv) or the row lse alone: (o or None, lse).
    walk: each tile's P.V from zero, added to O in fp32 ("tile"), or every
    tile chained in O's accumulator ("chain", the design before)."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    scale = _f32(1.0 / math.sqrt(dh))
    all_masked = ~mask.any(dim=1)
    valid = mask | all_masked[:, None]
    c = torch.where(all_masked, 0.0, _f32(np.float32(scale) * np.float32(LOG2E)))
    c = c.to(torch.float32)[:, None, None, None]
    shape = (b, h, nq, 1)
    m = torch.full(shape, -math.inf)
    mu, l = torch.zeros(shape), torch.zeros(shape)
    o = torch.zeros(q.shape)
    for k0 in range(0, nk, TILE_K):
        kt, vt = k[..., k0:k0 + TILE_K, :], v[..., k0:k0 + TILE_K, :]
        st = mma(torch.zeros((b, h, nq, kt.shape[2])), q, kt.transpose(-1, -2), passes, rounding)
        vmask = valid[:, None, None, k0:k0 + TILE_K]
        m_new = torch.maximum(m, torch.where(vmask, st, -math.inf).amax(dim=-1, keepdim=True))
        mu_new = torch.where(m_new == -math.inf, 0.0, m_new * c)
        alpha = torch.where(m == -math.inf, 0.0, torch.exp2(mu - mu_new))
        arg = (st.double() * c.double() - mu_new.double()).float()   # one FFMA: one rounding
        e = torch.where(vmask, torch.exp2(arg), 0.0)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        if with_pv and walk == "chain":
            o = mma(o * alpha, e, vt, passes, rounding)                # P unrounded, split for P.V
        elif with_pv:
            pv = mma(torch.zeros(o.shape), e, vt, passes, rounding)
            o = (o.double() * alpha.double() + pv.double()).float()   # one FFMA
        m, mu = m_new, mu_new
    lse = torch.where(all_masked[:, None, None], NEG, (m * scale + torch.log(l))[..., 0])
    return (o / l if with_pv else None), lse


def emulate_mass(q, k, key_mask, query_mask, lse, splits=1):
    """Kernel 6 from lse: [B, Nk] fp32, in the kernel's summation order."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    ntq = -(-nq // TILE_Q)
    c = _f32(np.float32(_f32(1.0 / math.sqrt(dh))) * np.float32(LOG2E))
    w = query_mask.bool()
    lse2 = torch.where(w[:, None, :], lse * _f32(LOG2E), math.inf)           # fp32 product
    lse2 = torch.nn.functional.pad(lse2, (0, ntq * TILE_Q - nq), value=math.inf)
    qp = torch.nn.functional.pad(q.float(), (0, 0, 0, ntq * TILE_Q - nq))    # zero-filled rows
    st = mma(torch.zeros((b, h, nk, ntq * TILE_Q)), k.float(), qp.transpose(-1, -2))   # S^T
    arg = (st.double() * c - lse2[:, :, None, :].double()).float()           # one FFMA: one rounding
    p = torch.exp2(arg).view(b, h, nk, ntq, 8, 4, 2)                         # tile, j, t, e: query 8j + 2t + e
    part = torch.zeros((b, h, nk, ntq, 4))
    for j in range(8):
        for e in range(2):
            part = part + p[..., j, :, e]
    kept_tile = torch.zeros((b, ntq * TILE_Q), dtype=torch.bool)
    kept_tile[:, :nq] = w
    kept_tile = kept_tile.view(b, ntq, TILE_Q).any(dim=2)

    valid = key_mask.bool()
    all_masked = ~valid.any(dim=1)
    uniform = _f32(h) * w.sum(dim=1).float() / _f32(nk)
    items = h * ntq
    total = None
    for s in range(splits):
        key_sum = torch.zeros((b, nk))
        for bi in range(b):
            acc = torch.zeros((nk, 4))
            for i in range(s * items // splits, (s + 1) * items // splits):
                if kept_tile[bi, i % ntq]:
                    acc = acc + part[bi, i // ntq, :, i % ntq]
            key_sum[bi] = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
        row = torch.where(all_masked[:, None], uniform[:, None] if s == 0 else 0.0,
                          torch.where(valid, key_sum, 0.0))
        total = row if total is None else total + row
    return total


def _forward_inputs(b, h, nq, nk, dh, seed=0):
    """fp32 q, k, v and a bool key mask: batch 0 a padded suffix, batch 1 a
    random pattern with its first key tile masked (the running max starts at
    -inf there), the last batch fully masked."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, nq, dh).astype(np.float32)
    k, v = (rs.randn(b, h, nk, dh).astype(np.float32) for _ in range(2))
    mask = rs.rand(b, nk) > 0.3
    mask[0] = np.arange(nk) < max(1, nk - 20)
    mask[1, :TILE_K] = False
    mask[1, -1] = True
    mask[-1] = False
    return (*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask))


def _mass_inputs(b, h, nq, nk, dh, seed=0):
    """fp32 q, k, bool masks: batch 0's keys a padded prefix, batch 1's a
    scattered subset (keypoints pooled away), the last batch's none; batch
    0's queries a padded prefix whose second 64-query tile keeps none
    (skipped), the others scattered."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(b, h, nq, dh).astype(np.float32))
    k = torch.from_numpy(rs.randn(b, h, nk, dh).astype(np.float32))
    key_mask = np.zeros((b, nk), bool)
    key_mask[0, :nk - 13] = True
    key_mask[1] = (np.arange(nk) < nk - 7) & (rs.rand(nk) > 0.5)
    query_mask = rs.rand(b, nq) > 0.3
    query_mask[0] = np.arange(nq) < min(nq, TILE_Q) - 9
    return q, k, torch.from_numpy(key_mask), torch.from_numpy(query_mask)


def _out_of_tolerance(a, ref, tol):
    return int(((a - ref).abs() > tol + tol * ref.abs()).sum())


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    """The rounding on hand-made values, and hi + lo within 2^-21 of x with
    both parts TF32 values (13 low bits clear)."""
    ulp = 2.0 ** -10                                  # TF32's unit at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp, 3.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32))
    hi, lo = split(r)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert bool(((hi.double() + lo.double() - r.double()).abs() <= 2.0 ** -21 * r.double().abs()).all())
    assert bool(((hi - r).abs() <= 2.0 ** -11 * r.abs()).all())


@pytest.mark.parametrize("b,h,nq,nk,dh", FWD_CASES)
def test_forward_design_matches_plain_versions(b, h, nq, nk, dh):
    """o against `mha_reference` (ATTN_TOL), lse against `mha_lse_reference`
    (FWD_LSE_TOL); the pass without P.V (the mass's standalone row lse) gives
    the same lse bits."""
    q, k, v, mask = _forward_inputs(b, h, nq, nk, dh)
    o, lse = emulate_forward(q, k, v, mask)
    ref_o, ref_lse = mha_lse_reference(q, k, v, mask)
    torch.testing.assert_close(o, mha_reference(q, k, v, mask), rtol=TOL, atol=TOL)
    torch.testing.assert_close(o, ref_o, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=FWD_LSE_TOL, atol=FWD_LSE_TOL)
    assert torch.equal(emulate_forward(q, k, v, mask, with_pv=False)[1], lse)


@pytest.mark.parametrize("b,h,nq,nk,dh", FWD_CASES)
def test_forward_fully_masked_batch_averages_v_with_lse_exactly_neg(b, h, nq, nk, dh):
    """The batch with no valid key: lse is -1e30 exactly and o is V's mean
    over all Nk keys, never NaN."""
    q, k, v, mask = _forward_inputs(b, h, nq, nk, dh)
    o, lse = emulate_forward(q, k, v, mask)
    assert bool((lse[-1] == NEG).all()) and bool((lse[:-1] > NEG).all())
    mean = v[-1].mean(dim=-2, keepdim=True).expand_as(o[-1])
    torch.testing.assert_close(o[-1], mean, rtol=1e-5, atol=1e-6)
    assert bool(torch.isfinite(o).all())


def test_single_pass_tf32_misses_the_fp32_tolerance():
    """One TF32 pass (hi.hi only, about 5e-4 relative a product) puts o out
    of ATTN_TOL[float32]: a kernel that dropped the lo terms fails there."""
    q, k, v, mask = _forward_inputs(*FWD_CASES[0])
    ref = mha_reference(q, k, v, mask)
    one_pass = emulate_forward(q, k, v, mask, passes=1)[0]
    three = emulate_forward(q, k, v, mask)[0]
    assert _out_of_tolerance(three, ref, TOL) == 0
    assert _out_of_tolerance(one_pass, ref, TOL) > 0.01 * ref.numel()


def _long_inputs(nk, seed=2):
    """fp32 q, k, v [LONG's b, h, nq, dh] with nk keys, the last 20 masked."""
    b, h, nq, dh = LONG
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, nq, dh).astype(np.float32)
    k, v = (rs.randn(b, h, nk, dh).astype(np.float32) for _ in range(2))
    mask = np.arange(nk)[None].repeat(b, 0) < nk - 20
    return (*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask))


def _rel_l2_fp64(o, q, k, v, mask):
    """o's largest relative L2 error a batch against masked attention in float64."""
    s = torch.where(mask[:, None, None, :], q.double() @ k.double().transpose(-1, -2) / q.shape[-1] ** 0.5, NEG)
    ref = (torch.softmax(s, dim=-1) @ v.double()).flatten(1)
    return ((o.double().flatten(1) - ref).norm(dim=1) / ref.norm(dim=1)).max().item()


@pytest.mark.parametrize("nk", [2048, 4096])
def test_tile_walk_holds_the_limit_under_toward_zero_accumulation(nk):
    """With every accumulation rounded toward zero, each tile's P.V from
    zero keeps o within FWD_O_REL_L2 of float64 at 2048 and 4096 keys, and
    its error does not double with the key count."""
    q, k, v, mask = _long_inputs(nk)
    err = _rel_l2_fp64(emulate_forward(q, k, v, mask, rounding="zero")[0], q, k, v, mask)
    assert err <= REL_L2 / 2, err


def test_chained_walk_misses_the_limit_under_toward_zero_accumulation():
    """The design before (P.V of every tile chained in O's accumulator)
    misses FWD_O_REL_L2 at 2048 keys under toward-zero rounding, as the card
    read 1.465e-05 against float64, and meets it rounding to nearest: the
    rounding of one long chain, not the split, loses the accuracy."""
    q, k, v, mask = _long_inputs(2048)
    chain = _rel_l2_fp64(emulate_forward(q, k, v, mask, walk="chain", rounding="zero")[0], q, k, v, mask)
    nearest = _rel_l2_fp64(emulate_forward(q, k, v, mask, walk="chain")[0], q, k, v, mask)
    assert chain > REL_L2 and nearest <= REL_L2 / 2, (chain, nearest)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("route", ["lse", "standalone"])
@pytest.mark.parametrize("b,h,nq,nk,dh", MASS_CASES)
def test_mass_design_matches_plain_versions(b, h, nq, nk, dh, route, splits):
    """The mass from kernel 4's lse (the lse route) or from the row-lse pass
    (standalone), at one split and three, against the two-pass plain version
    and the plain mass from the same lse (MASS_RTOL, MASS_ATOL)."""
    q, k, key_mask, query_mask = _mass_inputs(b, h, nq, nk, dh)
    _, lse = emulate_forward(q, k, k, key_mask, with_pv=route == "lse")
    out = emulate_mass(q, k, key_mask, query_mask, lse, splits)
    torch.testing.assert_close(out, attention_key_mass_reference(q, k, key_mask, query_mask),
                               rtol=MASS_RTOL, atol=MASS_ATOL)
    torch.testing.assert_close(out, attention_key_mass_from_lse_reference(q, k, key_mask, query_mask, lse),
                               rtol=MASS_RTOL, atol=MASS_ATOL)


@pytest.mark.parametrize("b,h,nq,nk,dh", MASS_CASES)
def test_mass_fully_masked_batch_spreads_over_every_key(b, h, nq, nk, dh):
    """The batch with no valid key gets H * (kept queries) / Nk on every key;
    masked keys of the other batches are 0."""
    q, k, key_mask, query_mask = _mass_inputs(b, h, nq, nk, dh)
    out = emulate_mass(q, k, key_mask, query_mask, emulate_forward(q, k, k, key_mask, with_pv=False)[1])
    want = h * query_mask[-1].sum().item() / nk
    torch.testing.assert_close(out[-1], torch.full((nk,), want), rtol=1e-6, atol=0.0)
    assert bool((out[:-1][~key_mask[:-1]] == 0).all())
    assert bool((out[:-1][key_mask[:-1]] > 0).all())


@functools.lru_cache(maxsize=1)
def _float_mask_case():
    """A small case with a float key mask holding negative, zero, fractional
    and above-one entries (the last batch has no entry > 0), and impx's
    mha_fused_lse and attention_key_mass on it, interpreted under jax.jit."""
    b, h, nq, nk, dh = 3, 2, 64, 80, 32
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(b, h, n, dh).astype(np.float32) for n in (nq, nk, nk))
    mask = rs.choice(np.array([-1.0, -0.5, 0.0, 0.5, 1.0, 2.0], np.float32), size=(b, nk))
    mask[-1] = -np.abs(mask[-1])
    query_mask = (rs.rand(b, nq) > 0.3).astype(np.float32)
    fused_lse = jax.jit(functools.partial(jax_mha_fused_lse, interpret=True))
    jo, jlse = fused_lse(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask))
    jmass = jax_key_mass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask), jnp.asarray(query_mask),
                         interpret=True)
    inputs = tuple(torch.from_numpy(x) for x in (q, k, v, mask, query_mask))
    outs = tuple(torch.from_numpy(np.array(x)) for x in (jo, jlse[..., 0], jmass))
    return inputs, outs


def test_design_matches_impx_interpreted():
    """The kernels' arithmetic on the mask the wrapper hands them (entries >
    0) against impx's Pallas kernels interpreted: o (ATTN_TOL), lse
    (FWD_LSE_TOL), the mass on both routes (MASS_RTOL, MASS_ATOL)."""
    (q, k, v, mask, query_mask), (jo, jlse, jmass) = _float_mask_case()
    valid = mask > 0
    o, lse = emulate_forward(q, k, v, valid)
    torch.testing.assert_close(o, jo, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, jlse, rtol=FWD_LSE_TOL, atol=FWD_LSE_TOL)
    for with_pv in (True, False):
        row_lse = emulate_forward(q, k, k, valid, with_pv=with_pv)[1]
        torch.testing.assert_close(emulate_mass(q, k, valid, query_mask > 0, row_lse), jmass,
                                   rtol=MASS_RTOL, atol=MASS_ATOL)


def test_float_key_mask_reads_positive_entries_as_valid_as_impx():
    """The plain versions read a float key mask as impx does (`> 0`): o and
    lse of `mha_lse_reference`, `mha_reference`, and the masses of
    `attention_key_mass_reference` and from lse, against impx interpreted. A
    reading of nonzero entries as valid misses impx on this mask."""
    (q, k, v, mask, query_mask), (jo, jlse, jmass) = _float_mask_case()
    o, lse = mha_lse_reference(q, k, v, mask)
    torch.testing.assert_close(o, jo, rtol=TOL, atol=TOL)
    torch.testing.assert_close(mha_reference(q, k, v, mask), jo, rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, jlse, rtol=FWD_LSE_TOL, atol=FWD_LSE_TOL)
    torch.testing.assert_close(attention_key_mass_reference(q, k, mask, query_mask), jmass,
                               rtol=MASS_RTOL, atol=MASS_ATOL)
    torch.testing.assert_close(attention_key_mass_from_lse_reference(q, k, mask, query_mask, lse), jmass,
                               rtol=MASS_RTOL, atol=MASS_ATOL)
    assert _out_of_tolerance(mha_reference(q, k, v, mask != 0), jo, TOL) > 0
