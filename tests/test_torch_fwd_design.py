"""The bf16 design of kernels 1 and 4 (impx_torch/csrc/attention.cu,
attn_fwd_wgmma), emulated in plain PyTorch on the CPU.

The kernel walks the keys in 64-key tiles with an online softmax in base 2:
p = 2^(s c - m c), c = log2(e) / sqrt(dh) folded into one FFMA a score, the
running max m kept in the scores' own (raw q.k) units, P rounded to bf16
against the running max before P.V, and l the fp32 sum of the unrounded p.
Masked keys and keys past Nk weigh 0. When no key of a batch is valid (the
reference gives every key -1e30 and so averages V uniformly), every key in
range counts with c = 0, and the row's lse is written as -1e30. Otherwise lse
= m / sqrt(dh) + log(l), in natural units.

These tests settle that arithmetic before the kernel meets the card: against
the plain versions `mha_reference` and `mha_lse_reference`, and against
impx's Pallas kernels `mha_fused` and `mha_fused_lse` in interpret mode, at
the card's limits (chip_smoke.py's ATTN_TOL, FWD_O_REL_L2, FWD_LSE_TOL)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_TOL, FWD_LSE_TOL, FWD_O_REL_L2
from impx.ops.pallas.attention import mha_fused as jax_mha_fused
from impx.ops.pallas.attention import mha_fused_lse as jax_mha_fused_lse
from impx_torch.ops.kernels.attention import NEG, mha_lse_reference, mha_reference

TILE = 64                      # keys a tile, as the kernel's kTileK
LOG2E = 1.4426950408889634
TOL = ATTN_TOL[torch.bfloat16]
O_REL_L2 = FWD_O_REL_L2[torch.bfloat16]

# (b, h, nq, nk, dh): ragged last key tiles (150, 77, 5), Nq not a multiple
# of the kernel's 128 query rows (200, 100, 17), one key tile exactly (64)
# and a multiple of it (256), dh 64, 32 and 16
CASES = [(3, 2, 200, 150, 64), (3, 2, 100, 77, 32), (3, 2, 17, 5, 16), (3, 2, 130, 256, 32),
         (3, 2, 64, 64, 16)]


def _inputs(b, h, nq, nk, dh, seed=0):
    """bf16 q, k, v and a bool key mask: batch 0 a padded suffix, batch 1 a
    random pattern with its first key tile masked (the running max starts at
    -inf there), the last batch fully masked."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, nq, dh).astype(np.float32)
    k, v = (rs.randn(b, h, nk, dh).astype(np.float32) for _ in range(2))
    mask = rs.rand(b, nk) > 0.3
    mask[0] = np.arange(nk) < max(1, nk - 20)
    mask[1, :TILE] = False
    mask[1, -1] = True
    mask[-1] = False
    return q, k, v, mask


def _torch(q, k, v, mask):
    return (*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), torch.from_numpy(mask))


def _emulate(q, k, v, mask):
    """The kernel's arithmetic: (o in fp32 before its bf16 rounding, lse)."""
    dh, nk = q.shape[-1], k.shape[2]
    scale = float(np.float32(1.0 / math.sqrt(dh)))
    all_masked = ~mask.any(dim=1)
    valid = mask | all_masked[:, None]
    c = torch.where(all_masked, 0.0, float(np.float32(scale) * np.float32(LOG2E)))
    c = c.to(torch.float32)[:, None, None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))   # bf16 products, exact in fp32
    shape = s.shape[:-1] + (1,)
    m = torch.full(shape, -math.inf)
    mu, l = torch.zeros(shape), torch.zeros(shape)
    o = torch.zeros(q.shape)
    for k0 in range(0, nk, TILE):
        st, vt = s[..., k0:k0 + TILE], valid[:, None, None, k0:k0 + TILE]
        m_new = torch.maximum(m, torch.where(vt, st, -math.inf).amax(dim=-1, keepdim=True))
        mu_new = torch.where(m_new == -math.inf, 0.0, m_new * c)
        alpha = torch.where(m == -math.inf, 0.0, torch.exp2(mu - mu_new))
        arg = (st.double() * c.double() - mu_new.double()).float()   # one FFMA: one rounding
        e = torch.where(vt, torch.exp2(arg), 0.0)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(e.to(torch.bfloat16).float(), v[..., k0:k0 + TILE, :].float())
        m, mu = m_new, mu_new
    lse = torch.where(all_masked[:, None, None], NEG, (m * scale + torch.log(l))[..., 0])
    return o / l, lse


def _rel_l2(a, r):
    return ((a.float() - r.float()).flatten(1).norm(dim=1) / r.float().flatten(1).norm(dim=1))


@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_design_matches_plain_versions(b, h, nq, nk, dh):
    """o in bf16 against `mha_reference` elementwise (ATTN_TOL) and each
    batch by relative L2 (FWD_O_REL_L2, kernel 4's limit); lse against
    `mha_lse_reference` elementwise (FWD_LSE_TOL)."""
    q, k, v, mask = _torch(*_inputs(b, h, nq, nk, dh))
    o32, lse = _emulate(q, k, v, mask)
    o = o32.to(torch.bfloat16)
    ref, (ref_o, ref_lse) = mha_reference(q, k, v, mask), mha_lse_reference(q, k, v, mask)
    torch.testing.assert_close(o.float(), ref.float(), rtol=TOL, atol=TOL)
    assert bool((_rel_l2(o, ref_o) <= O_REL_L2).all()), _rel_l2(o, ref_o).tolist()
    torch.testing.assert_close(lse, ref_lse, rtol=FWD_LSE_TOL, atol=FWD_LSE_TOL)


@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_design_matches_impx_interpreted(b, h, nq, nk, dh):
    """Against impx's Pallas kernels in interpret mode on the same bf16
    inputs: o from mha_fused and mha_fused_lse (ATTN_TOL), lse (FWD_LSE_TOL)."""
    qn, kn, vn, mask_np = _inputs(b, h, nq, nk, dh)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (qn, kn, vn))
    jo = jax_mha_fused(jq, jk, jv, jnp.asarray(mask_np), interpret=True)
    jo_lse, jlse = jax_mha_fused_lse(jq, jk, jv, jnp.asarray(mask_np), interpret=True)
    o32, lse = _emulate(*_torch(qn, kn, vn, mask_np))
    o = o32.to(torch.bfloat16).float()
    for ref in (jo, jo_lse):
        torch.testing.assert_close(o, torch.from_numpy(np.array(ref.astype(jnp.float32))),
                                   rtol=TOL, atol=TOL)
    torch.testing.assert_close(lse, torch.from_numpy(np.array(jlse))[..., 0],
                               rtol=FWD_LSE_TOL, atol=FWD_LSE_TOL)


@pytest.mark.parametrize("b,h,nq,nk,dh", CASES)
def test_fully_masked_batch_averages_v_with_lse_exactly_neg(b, h, nq, nk, dh):
    """The batch with no valid key: lse is -1e30 exactly (route B's backward
    rebuilds p = exp(s - lse) = 1 from it), and o is V's mean over all Nk keys
    (to fp32 summation order before the bf16 rounding), never NaN."""
    q, k, v, mask = _torch(*_inputs(b, h, nq, nk, dh))
    o32, lse = _emulate(q, k, v, mask)
    assert bool((lse[-1] == NEG).all())
    assert bool((lse[:-1] > NEG).all())
    mean = v[-1].float().mean(dim=-2, keepdim=True).expand_as(o32[-1])
    torch.testing.assert_close(o32[-1], mean, rtol=1e-5, atol=1e-6)
    assert bool(torch.isfinite(o32).all())
