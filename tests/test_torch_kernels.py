"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor impx, so it runs where the card is:
    python -m pytest --noconftest -q tests/test_torch_kernels.py
(--noconftest: tests/conftest.py imports jax). Without a CUDA device every
test here skips. It also holds the numpy input makers that
tests/test_torch_ops.py and tests/test_torch_eimp.py share."""
import re

import numpy as np
import pytest
import torch

from impx_torch.models import AdaGMN, DGNNS, MatcherConfig, SuperGlue
from impx_torch.ops.kernels.attention import (
    attention_key_mass, attention_key_mass_reference, mha_bwd, mha_bwd_from_lse,
    mha_bwd_from_lse_reference, mha_bwd_reference, mha_fused, mha_fused_lse, mha_lse_reference,
    mha_reference)
from impx_torch.ops.kernels.log_sinkhorn import log_sinkhorn_fused_stats, log_sinkhorn_stats_reference
from impx_torch.ops.kernels.sinkhorn import sinkhorn_fused_stats, sinkhorn_stats_reference


def attention_inputs(seed=0, b=3, h=4, nq=128, nk=192, dh=64):
    """Key masks: a padded prefix, a random pattern, and a fully masked row
    set (every query of batch 2 sees no valid key); Nq != Nk."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, n, dh).astype(np.float32) for n in (nq, nk, nk))
    mask = np.zeros((b, nk), bool)
    mask[0, :150] = True
    mask[1] = rs.rand(nk) > 0.4
    return q, k, v, mask


def sinkhorn_case(b, n, m, n0, n1, seed=0):
    rs = np.random.RandomState(seed)
    dist = (rs.randn(b, n, m) * 2).astype(np.float32)
    valid0 = np.arange(n)[None] < np.asarray(n0)[:, None]
    valid1 = np.arange(m)[None] < np.asarray(n1)[:, None]
    return dist, np.float32(0.7), valid0, valid1


def overlap_pairs(rs, b, n, d, valid_share, noise=0.01):
    """Pairs that overlap in part: half of image 1's slots hold a permuted,
    noised copy of an image 0 keypoint (with its validity), the rest are
    fresh keypoints; validity is scattered at valid_share. Some keypoints
    match, and the rest can be pooled away."""
    d0, d1 = rs.randn(2, b, n, d).astype(np.float32)
    k0, k1 = (rs.rand(2, b, n, 2) - 0.5).astype(np.float32)
    s0, s1 = rs.rand(2, b, n).astype(np.float32)
    v0, v1 = rs.rand(2, b, n) < valid_share
    perm = np.stack([rs.permutation(n) for _ in range(b)])
    take = lambda x: np.take_along_axis(x, perm.reshape(perm.shape + (1,) * (x.ndim - 2)), axis=1)
    shared = rs.rand(b, n) < 0.5
    pick = lambda a, c: np.where(shared.reshape(shared.shape + (1,) * (a.ndim - 2)), a, c)
    return {
        "descriptors0": d0,
        "descriptors1": pick(take(d0) + noise * rs.randn(b, n, d).astype(np.float32), d1),
        "norm_keypoints0": k0, "norm_keypoints1": pick(take(k0), k1),
        "scores0": s0, "scores1": pick(take(s0), s1),
        "valid0": v0, "valid1": pick(take(v0), v1),
    }


SINKHORN_CASES = [
    (2, 256, 256, [200, 256], [180, 256]),   # masked + full
    (2, 256, 128, [256, 100], [128, 90]),    # rectangular
    (2, 512, 512, [30, 512], [25, 512]),     # heavily masked
    (1, 1280, 1280, [1100], [1200]),         # bf16 plan (above the 6 MiB rule)
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# tolerances against the plain version on the same card: fp32 differs only by
# summation order and the online softmax's rescaling; bf16 P is rounded
# relative to a running max instead of the final one, which can move the
# bf16 output by one ulp (2^-8 relative)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


# kernels 1 and 4 at the edges of the bf16 kernel's tiles (128 query rows a
# block, 64-key tiles): Nq under 64 and not a multiple of 128, Nk under one
# key tile and a multiple of it, dh 16, 32 and 64
FWD_SHAPES = [(128, 192, 64), (100, 77, 32), (17, 5, 16), (200, 256, 64), (200, 64, 16)]
FWD_IDS = ["128-192-64", "100-77-32", "17-5-16", "200-256-64", "200-64-16"]


def _forward_inputs(device, dtype, nq, nk, dh, mask_dtype):
    q, k, v, mask = attention_inputs(nq=nq, nk=nk, dh=dh)
    q, k, v = (torch.from_numpy(x).to(device, dtype) for x in (q, k, v))
    return q, k, v, torch.from_numpy(mask).to(device, mask_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.float32], ids=["bool-mask", "float-mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk,dh", FWD_SHAPES, ids=FWD_IDS)
def test_attention_kernel_matches_plain(cuda_device, dtype, nq, nk, dh, mask_dtype):
    """Kernel 1 against its plain version (batch 2 fully masked), twice for
    the same bits."""
    q, k, v, mask = _forward_inputs(cuda_device, dtype, nq, nk, dh, mask_dtype)
    before = mha_fused.launches
    out, again = mha_fused(q, k, v, mask), mha_fused(q, k, v, mask)
    torch.cuda.synchronize()
    assert mha_fused.launches == before + 2
    assert torch.equal(out, again)
    ref = mha_reference(q, k, v, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.float32], ids=["bool-mask", "float-mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk,dh", FWD_SHAPES, ids=FWD_IDS)
def test_attention_lse_kernel_matches_plain(cuda_device, dtype, nq, nk, dh, mask_dtype):
    """Kernel 4 alone (the forward of route B) against its plain version: o
    as kernel 1, lse elementwise within 1e-5 and exactly -1e30 on the fully
    masked batch; twice for the same bits."""
    q, k, v, mask = _forward_inputs(cuda_device, dtype, nq, nk, dh, mask_dtype)
    before = mha_fused_lse.launches
    (o, lse), (o2, lse2) = mha_fused_lse(q, k, v, mask), mha_fused_lse(q, k, v, mask)
    torch.cuda.synchronize()
    assert mha_fused_lse.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rlse = mha_lse_reference(q, k, v, mask)
    torch.testing.assert_close(o.float(), ro.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    assert bool((lse[2] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("fn", [mha_fused, mha_fused_lse], ids=["kernel-1", "kernel-4"])
def test_attention_forward_reads_the_bool_mask_in_place(cuda_device, fn, dtype):
    """A forward (bf16 or fp32) with a bool key mask launches the attention
    kernel and no other device operation (a cast of the mask would add one):
    three calls under torch.profiler, then a spin kernel, so that the calls'
    events are not the profile's last (a profile can lose its last one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v, mask = _forward_inputs(cuda_device, dtype, 200, 256, 64, torch.bool)
    fn(q, k, v, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(q, k, v, mask)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    attention = [n for n in names if "attn_fwd" in n]
    others = [n for n in names if "attn_fwd" not in n and "spin" not in n]
    assert attention and not others, names


# the persistent schedule's edges on the card (one CTA an SM): 8 pairs of
# 2048 keypoints put about half of each CTA's rows in the overflow buffer; one
# pair of 100 keypoints has fewer rows than the card has CTAs (one row a
# CTA); 3 x 701 rows do not divide among 3 x 44 CTAs
PERSISTENT_CASES = [
    (8, 2048, 2048, [2048, 1900, 1748, 2000, 1800, 2048, 1760, 1999],
     [1950, 2048, 1800, 1748, 2048, 1900, 2001, 1777]),
    (1, 100, 100, [90], [80]),
    (3, 700, 650, [700, 600, 650], [650, 500, 620]),
]
PERSISTENT_IDS = ["8x2048-overflow", "1x100-fewer-rows-than-ctas", "3x700-ragged-split"]


def _check_sinkhorn(device, b, n, m, n0, n1, iterations=20):
    """Kernel 2 against its plain version (rtol 1e-3, atol 1e-6, at most 1e-3
    of the indices flipped), twice for the same bits."""
    dist, bin_, valid0, valid1 = sinkhorn_case(b, n, m, n0, n1)
    args = [torch.from_numpy(a).to(device) for a in (dist, valid0, valid1)]
    bin_t = torch.tensor(bin_, device=device)
    before = sinkhorn_fused_stats.launches
    out, again = (sinkhorn_fused_stats(args[0], bin_t, iterations, args[1], args[2]) for _ in range(2))
    torch.cuda.synchronize()
    assert sinkhorn_fused_stats.launches == before + 2
    assert all(torch.equal(out[k], again[k]) for k in out)
    ref = sinkhorn_stats_reference(args[0], bin_t, iterations, args[1], args[2])
    for key in ("u", "v", "max0", "rowmass", "colmass"):
        torch.testing.assert_close(out[key], ref[key], rtol=1e-3, atol=1e-6, msg=key)
    for key in ("idx0", "idx1"):  # a flip needs a near-tie within fp32 noise
        assert (out[key] != ref[key]).float().mean().item() <= 1e-3, key


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,n0,n1", SINKHORN_CASES)
def test_sinkhorn_kernel_matches_plain(cuda_device, b, n, m, n0, n1):
    _check_sinkhorn(cuda_device, b, n, m, n0, n1)


def _check_log_sinkhorn(device, b, n, m, n0, n1, iterations):
    dist, bin_, valid0, valid1 = sinkhorn_case(b, n, m, n0, n1)
    dist, valid0, valid1 = (torch.from_numpy(a).to(device) for a in (dist, valid0, valid1))
    bin_t = torch.tensor(bin_, device=device)
    before = log_sinkhorn_fused_stats.launches
    out, again = (log_sinkhorn_fused_stats(dist, bin_t, iterations, valid0, valid1) for _ in range(2))
    torch.cuda.synchronize()
    assert log_sinkhorn_fused_stats.launches == before + 2
    ref = log_sinkhorn_stats_reference(dist, bin_t, iterations, valid0, valid1)
    one = torch.ones((b, 1), dtype=torch.bool, device=device)
    for key, ok, sign in (("u", torch.cat([valid0, one], 1), -1), ("v", torch.cat([valid1, one], 1), 1)):
        assert torch.isfinite(out[key]).all(), key
        fixed, ref_fixed = (x[key] + sign * x["u"][:, n:] for x in (out, ref))
        torch.testing.assert_close(fixed[ok], ref_fixed[ok], rtol=1e-4, atol=1e-5, msg=key)
        torch.testing.assert_close(out[key][~ok], ref[key][~ok], rtol=0, atol=1e23, msg=key)
    torch.testing.assert_close(out["max0"], ref["max0"], rtol=1e-4, atol=1e-5)
    for key in ("idx0", "idx1"):  # a flip needs a near-tie within fp32 noise
        assert (out[key] != ref[key]).float().mean().item() <= 1e-3, key
    assert all(torch.equal(out[k], again[k]) for k in out)


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [20, 100])
@pytest.mark.parametrize("b,n,m,n0,n1", SINKHORN_CASES + [(1, 31, 49152, [31], [40000])])
def test_log_sinkhorn_kernel_matches_plain(cuda_device, b, n, m, n0, n1, iterations):
    """Kernel 7 against its plain version: both round Z alike (the last two
    cases store it in bf16; the last has no padded row, where impx's kernel
    turns to NaN), so they differ by the summation order only (rtol 1e-4,
    atol 1e-5). u and v are defined up to u + c, v - c (the log plan holds
    u_i + v_j), and the plain version's roundings walk along c, in the
    heavily masked case at 100 iterations past atol 1e-5 where |v| is small.
    So u - u_N and v + u_N (u_N the dustbin row's) are held,
    and max0; u and v at invalid entries within 1e23 (they hold about 2.56e26
    under the bf16 rule); a second run gives the same bits."""
    _check_log_sinkhorn(cuda_device, b, n, m, n0, n1, iterations)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,n0,n1", PERSISTENT_CASES, ids=PERSISTENT_IDS)
def test_sinkhorn_kernels_at_the_schedule_edges(cuda_device, b, n, m, n0, n1):
    """Kernels 2 and 7 against their plain versions where the persistent
    schedule is unusual: overflow rows, fewer rows than CTAs, a row count
    that does not divide among the CTAs. The schedule's rows add up, and
    only the first case spills."""
    from impx_torch.ops.kernels import log_sinkhorn as kl
    from impx_torch.ops.kernels import sinkhorn as ks

    for sched in (ks.schedule(b, n, m, cuda_device), kl.schedule(b, n, m, cuda_device)):
        assert sched["rows_on_chip"] + sched["overflow_rows"] == b * (n + 1)
        assert sched["ctas"] <= torch.cuda.get_device_properties(cuda_device).multi_processor_count
        assert (sched["overflow_rows"] > 0) == (b == 8), sched
    _check_sinkhorn(cuda_device, b, n, m, n0, n1)
    _check_log_sinkhorn(cuda_device, b, n, m, n0, n1, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sinkhorn", "log_sinkhorn"])
def test_sinkhorn_kernels_replay_in_a_cuda_graph(cuda_device, kernel):
    """A wrapper call captured in a CUDA graph (the cooperative launch goes
    through ctypes on the capturing stream) replays to a direct call's bits."""
    fn = sinkhorn_fused_stats if kernel == "sinkhorn" else log_sinkhorn_fused_stats
    dist, bin_, valid0, valid1 = sinkhorn_case(2, 700, 650, [700, 600], [650, 500])
    args = [torch.from_numpy(a).to(cuda_device) for a in (dist, valid0, valid1)]
    call = lambda: fn(args[0], torch.tensor(bin_, device=cuda_device), 20, args[1], args[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    bin_t = torch.tensor(bin_, device=cuda_device)
    with torch.cuda.graph(graph):
        captured = fn(args[0], bin_t, 20, args[1], args[2])
    graph.replay()
    graph.replay()
    direct = fn(args[0], bin_t, 20, args[1], args[2])
    torch.cuda.synchronize()
    assert all(torch.equal(captured[k], direct[k]) for k in direct)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sinkhorn", "log_sinkhorn"])
def test_sinkhorn_wrapper_call_is_one_device_launch(cuda_device, kernel):
    """One wrapper call of kernel 2 or 7 issues at most 3 device operations,
    all of them its persistent kernel (the design issues 1): three calls
    under torch.profiler, then a spin kernel, so that the calls' events are
    not the profile's last (a profile can lose its last one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = sinkhorn_fused_stats if kernel == "sinkhorn" else log_sinkhorn_fused_stats
    dist, bin_, valid0, valid1 = sinkhorn_case(4, 2048, 2048, [2048, 1900, 1800, 2000], [2000, 2048, 1750, 1900])
    args = [torch.from_numpy(a).to(cuda_device) for a in (dist, valid0, valid1)]
    bin_t = torch.tensor(bin_, device=cuda_device)
    fn(args[0], bin_t, 20, args[1], args[2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(args[0], bin_t, 20, args[1], args[2])
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and "spin" not in e.name]
    ours = [n_ for n_ in names if f"{kernel}_persistent" in n_]
    assert ours and len(names) == len(ours) and len(ours) <= 3 * 3, names


@pytest.mark.cuda
def test_log_ot_matchers_kernel_path_match_plain_path(cuda_device):
    """DGNNS under log_ot and SuperGlue (random batch-norm statistics,
    descriptors twice the unit scale so random weights match) at fp32: one
    attention launch a layer and one log-Sinkhorn call, the same indices as
    the plain path."""
    rs = np.random.RandomState(4)
    b, n = 2, 200
    d0 = rs.randn(b, n, 64).astype(np.float32)
    perm = rs.permutation(n)
    data = {"descriptors0": 2 * d0, "descriptors1": 2 * (d0[:, perm] + 0.01 * rs.randn(b, n, 64)),
            "norm_keypoints0": rs.rand(b, n, 2) - 0.5, "scores0": rs.rand(b, n),
            "valid0": np.arange(n)[None].repeat(b, 0) < 180}
    data["norm_keypoints1"] = data["norm_keypoints0"][:, perm]
    data["scores1"] = data["scores0"][:, perm]
    data["valid1"] = data["valid0"][:, perm]
    data = {k: v.astype(np.float32) if v.dtype != bool else v for k, v in data.items()}
    small = dict(descriptor_dim=64, keypoint_encoder=(32, 64), n_layers=4, num_heads=4)
    superglue = SuperGlue(MatcherConfig(**small, norm_fn="bn", sinkhorn_iterations=100), device=cuda_device)
    with torch.no_grad():
        for norm in (m for m in superglue.modules() if hasattr(m, "bn_var")):
            c = norm.bn_var.shape[0]
            norm.bn_scale.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, c)))
            norm.bn_mean.copy_(torch.from_numpy(0.3 * rs.randn(c)))
            norm.bn_var.copy_(torch.from_numpy(rs.uniform(0.3, 2.0, c)))
    dgnns = DGNNS(MatcherConfig(**small, norm_fn="in", log_ot=True), device=cuda_device)
    for model, call in ((dgnns, lambda d: dgnns.produce_matches(d, only_last=True, with_scores=False)),
                        (superglue, lambda d: superglue.produce_matches(d, only_last=True))):
        launches = (mha_fused.launches, log_sinkhorn_fused_stats.launches)
        out = call(data)
        assert (mha_fused.launches - launches[0], log_sinkhorn_fused_stats.launches - launches[1]) == (8, 1)
        model.use_kernels = False
        ref = call(data)
        idx, ridx = out["indices0"][0], ref["indices0"][0]
        assert torch.equal(idx, ridx), type(model).__name__
        assert ((idx >= 0).sum(dim=1) >= 45).all(), type(model).__name__  # a quarter of the 180 valid rows


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_matcher_kernel_path_matches_plain_path(cuda_device, compute_dtype):
    cfg = MatcherConfig(descriptor_dim=64, keypoint_encoder=(32, 64), n_layers=4,
                        num_heads=4, norm_fn="in", compute_dtype=compute_dtype)
    model = DGNNS(cfg, device=cuda_device)
    rs = np.random.RandomState(0)
    b, n = 2, 200
    d0 = rs.randn(b, n, 64).astype(np.float32)
    perm = rs.permutation(n)
    data = {"descriptors0": d0, "descriptors1": d0[:, perm] + 0.01 * rs.randn(b, n, 64),
            "norm_keypoints0": rs.rand(b, n, 2) - 0.5, "scores0": rs.rand(b, n),
            "valid0": np.arange(n)[None].repeat(b, 0) < 180}
    data["norm_keypoints1"] = data["norm_keypoints0"][:, perm]
    data["scores1"] = data["scores0"][:, perm]
    data["valid1"] = data["valid0"][:, perm]
    data = {k: v.astype(np.float32) if v.dtype != bool else v for k, v in data.items()}
    launches = (mha_fused.launches, sinkhorn_fused_stats.launches)
    out = model.produce_matches(data, only_last=True, with_scores=False)
    assert (mha_fused.launches - launches[0], sinkhorn_fused_stats.launches - launches[1]) == (8, 1)
    model.use_kernels = False
    ref = model.produce_matches(data, only_last=True, with_scores=False)
    idx, ridx = out["indices0"][0], ref["indices0"][0]
    assert (idx == ridx).float().mean().item() >= (1.0 if compute_dtype == "float32" else 0.97)
    assert ((idx >= 0).sum(dim=1) >= 45).all()  # a quarter of the 180 valid rows


def _mass_inputs(device, dtype, h, nq, nk, dh):
    """attention_inputs' key masks (batch 2 fully masked) and a query mask
    with zeros."""
    q, k, _, mask = attention_inputs(h=h, nq=nq, nk=nk, dh=dh)
    qmask = np.random.RandomState(1).rand(q.shape[0], nq) > 0.3
    q, k = (torch.from_numpy(x).to(device, dtype) for x in (q, k))
    return (q, k, *(torch.from_numpy(x).to(device) for x in (mask, qmask)))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["lse", "standalone"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,nq,nk,dh", [(4, 128, 192, 64), (2, 100, 77, 32), (2, 300, 260, 16)])
def test_attention_key_mass_kernel_matches_plain(cuda_device, dtype, h, nq, nk, dh, route):
    """Against the plain version on the card, from kernel 4's row lse (the lse
    route, EIMP's) or from the wrapper's own (standalone): summation order
    only, so rtol 1e-4 and atol 1e-6, the fully masked batch 2 included (H *
    kept queries / Nk on every key); a second run on the same inputs gives
    the same bits (no atomics)."""
    q, k, mask, qmask = _mass_inputs(cuda_device, dtype, h, nq, nk, dh)
    lse = mha_fused_lse(q, k, k, mask)[1] if route == "lse" else None
    before = attention_key_mass.launches
    out = attention_key_mass(q, k, mask, qmask, lse)
    again = attention_key_mass(q, k, mask, qmask, lse)
    torch.cuda.synchronize()
    assert attention_key_mass.launches == before + 2
    assert torch.equal(out, again)
    ref = attention_key_mass_reference(q, k, mask, qmask)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(out[2], torch.full_like(out[2], h * qmask[2].sum().item() / nk), rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_key_mass_splits_agree(cuda_device, dtype):
    """Any split of the (head, query tile) items gives the plain version's
    mass, each split count the same bits twice; more splits than items leave
    some empty."""
    q, k, mask, qmask = _mass_inputs(cuda_device, dtype, 4, 300, 260, 32)
    lse = mha_fused_lse(q, k, k, mask)[1]
    ref = attention_key_mass_reference(q, k, mask, qmask)
    for splits in (1, 2, 3, 8, 40):
        out = attention_key_mass(q, k, mask, qmask, lse, splits=splits)
        assert torch.equal(out, attention_key_mass(q, k, mask, qmask, lse, splits=splits)), splits
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("compaction", [(), ((4, 128),)], ids=["mask-only", "compacted"])
def test_adagmn_kernel_path_matches_plain_path(cuda_device, compaction):
    """EIMP at fp32 on the card, per call: 8 launches of kernel 1 and 4 of
    kernel 4 (the two layers of each of the pooling iterations 3 and 5, whose
    row lse the masses take), 6 Sinkhorn calls and 4 mass launches."""
    cfg = MatcherConfig(descriptor_dim=64, keypoint_encoder=(32, 64), n_layers=6, num_heads=4,
                        norm_fn="in", n_min_tokens=16, compaction=compaction)
    model = AdaGMN(cfg, device=cuda_device)
    model.bin_score.data.fill_(6.0)  # unmatched rows' mass to the dustbin: pooling drops them
    data = overlap_pairs(np.random.RandomState(0), 2, 256, 64, valid_share=0.35)
    kernels = (mha_fused, mha_fused_lse, sinkhorn_fused_stats, attention_key_mass)
    before = [fn.launches for fn in kernels]
    out = model.produce_matches(data, only_last=True, with_scores=False)
    assert [fn.launches - n for fn, n in zip(kernels, before)] == [8, 4, 6, 4]
    model.use_kernels = False
    ref = model.produce_matches(data, only_last=True, with_scores=False)
    valid0 = torch.from_numpy(data["valid0"]).to(cuda_device)
    assert bool((out["keep0"].sum(dim=1) < valid0.sum(dim=1)).any())  # pooling dropped some
    for key in ("keep0", "keep1"):
        assert torch.equal(out[key], ref[key]), key
    assert torch.equal(out["indices0"][-1], ref["indices0"][-1])


# the training kernels' dq, dk and dv against their plain versions on the
# card, by the relative L2 error of each batch (the fully masked one
# included: kernel 5's p = 1 there makes its outputs about Nk times larger,
# which an elementwise atol would not scale with). fp32: the sums run in
# another order. bf16: both sides round the outputs once (2^-8 relative), and
# kernel 5 also rounds p and ds to bf16, so an fp32 difference flips a
# rounding now and then; a kernel 5 that dropped delta would move dq by about
# 0.14 and dk by about 0.06
BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _rel_l2_per_batch(a, r):
    diff = (a.float() - r.float()).flatten(1).norm(dim=1)
    return diff / r.float().flatten(1).norm(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nk,dh,one_key", [
    (128, 192, 64, False), (100, 77, 32, False),
    (1000, 1030, 64, False),   # many 64-row tiles, neither length a multiple of 64
    (100, 77, 16, False),      # dh = 16
    (130, 200, 64, True),      # batch 0 has exactly one valid key
], ids=["128-192-64", "100-77-32", "1000-1030-64", "100-77-16", "one-valid-key"])
def test_attention_training_kernels_match_plain(cuda_device, dtype, nq, nk, dh, one_key):
    """Kernel 4 (forward with lse), kernel 3 and kernel 5 against their plain
    versions, with padded keys, random masks and a fully masked batch; the
    backward kernels give the same bits on a second run (no atomics). With
    one valid key, p = 1 on it and ds = p (dp - delta) is 0 up to rounding,
    so that batch's dq and dk are held against the norm of the other batches
    with valid keys (relative to their own zero norm would divide by 0)."""
    q, k, v, mask = attention_inputs(nq=nq, nk=nk, dh=dh)
    if one_key:
        mask[0] = False
        mask[0, nk // 2] = True
    do = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    q, k, v, do = (torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v, do))
    mask = torch.from_numpy(mask).to(cuda_device)
    before = (mha_fused_lse.launches, mha_bwd.launches, mha_bwd_from_lse.launches)
    o, lse = mha_fused_lse(q, k, v, mask)
    g3, g3_again = mha_bwd(q, k, v, mask, do), mha_bwd(q, k, v, mask, do)
    g5, g5_again = (mha_bwd_from_lse(q, k, v, mask, lse, o, do) for _ in range(2))
    torch.cuda.synchronize()
    assert (mha_fused_lse.launches, mha_bwd.launches, mha_bwd_from_lse.launches) == tuple(
        n + d for n, d in zip(before, (1, 2, 2)))
    ro, rlse = mha_lse_reference(q, k, v, mask)
    torch.testing.assert_close(o.float(), ro.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    assert bool((lse[2] == -1e30).all())
    for kernel, got, again, ref in (
            ("kernel 3", g3, g3_again, mha_bwd_reference(q, k, v, mask, do)),
            ("kernel 5", g5, g5_again, mha_bwd_from_lse_reference(q, k, v, mask, lse, o, do))):
        for name, a, b, r in zip(("dq", "dk", "dv"), got, again, ref):
            assert a.dtype == dtype and torch.equal(a, b), (kernel, name)
            assert torch.isfinite(a.float()).all(), (kernel, name)
            if one_key and name != "dv":
                err = (a[0].float() - r[0].float()).norm()
                assert err <= BWD_REL_L2[dtype] * r[1].float().norm(), (kernel, name, err.item())
                a, r = a[1:], r[1:]
            rel = _rel_l2_per_batch(a, r)
            assert bool((rel <= BWD_REL_L2[dtype]).all()), (kernel, name, rel.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kernel", ["kernel-3", "kernel-5"])
def test_attention_backward_reads_the_bool_mask_in_place(cuda_device, kernel, dtype):
    """A backward (bf16 or fp32) with a bool key mask launches its two kernels
    a call and no other device operation; a float mask takes one device
    operation more a call (its entries > 0 as a bool mask) and gives the same
    bits as the bool mask it stands for. Three calls each under
    torch.profiler, then a spin kernel, so that the calls' events are not the
    profile's last (a profile can lose its last one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v, mask = _forward_inputs(cuda_device, dtype, 200, 256, 64, torch.bool)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda_device, dtype)
    o, lse = mha_fused_lse(q, k, v, mask)
    float_mask = torch.where(mask, 1.5, -0.5)   # read as > 0: the bool mask again

    def run(m):
        if kernel == "kernel-3":
            return mha_bwd(q, k, v, m, do)
        return mha_bwd_from_lse(q, k, v, m, lse, o, do)

    for m, others_a_call in ((mask, 0), (float_mask, 1)):
        run(m)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run(m)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        backward = [n for n in names if "bwd_" in n]
        others = [n for n in names if "bwd_" not in n and "spin" not in n]
        assert len(backward) == 6 and len(others) == 3 * others_a_call, names
    for a, b in zip(run(mask), run(float_mask)):
        assert torch.equal(a, b)


def _zero_grad_leaves(model):
    """Leaves whose exact gradient is 0 (a bias that shifts every valid token
    of a channel alike before a masked InstanceNorm, k's bias); the keypoint
    encoder's last block has no norm after it."""
    last = len(model.kenc.blocks) - 1
    return re.compile(rf"(kenc\.blocks\.[0-{last - 1}]\.bias|attn\.[kv]\.bias|merge\.bias|proj\.bias"
                      r"|mlp\.blocks\.0\.bias)$")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True], ids=["route-A", "route-B"])
def test_forward_train_kernel_path_matches_plain_path(cuda_device, fused, compute_dtype):
    """DGNNS.forward_train on the card: each route launches its forward and
    backward kernel once per layer, and the loss and the gradients agree with
    the plain path. fp32: rtol 1e-4, atol 1e-6. bf16 (the training stream):
    loss rtol 1e-2 and a cosine of at least 0.99 on every leaf whose exact
    gradient is not 0, as chip_smoke.py holds the published config. Under
    grad every norm keeps the plain chain (counter impx.norm: none fused)."""
    cfg = MatcherConfig(descriptor_dim=64, keypoint_encoder=(32, 64), n_layers=4, num_heads=4,
                        norm_fn="in", train_fused=fused, compute_dtype=compute_dtype)
    model = DGNNS(cfg, device=cuda_device)
    rs = np.random.RandomState(3)
    b, n = 2, 130
    data = {"descriptors0": rs.randn(b, n, 64), "descriptors1": rs.randn(b, n, 64),
            "norm_keypoints0": rs.rand(b, n, 2) - 0.5, "norm_keypoints1": rs.rand(b, n, 2) - 0.5,
            "scores0": rs.rand(b, n), "scores1": rs.rand(b, n),
            "valid0": np.arange(n)[None].repeat(b, 0) < 120,
            "valid1": np.arange(n)[None].repeat(b, 0) < 111}
    gt = np.zeros((b, n + 1, n + 1))
    gt[:, np.arange(100), np.arange(100)] = 1
    gt[:, np.arange(100, 120), n] = 1
    gt[:, n, np.arange(100, 111)] = 1
    data["matching_mask"] = gt
    from impx_torch.tools import profiling

    fwd, bwd = (mha_fused_lse, mha_bwd_from_lse) if fused else (mha_fused, mha_bwd)
    grads = []
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        model.zero_grad()
        before = (fwd.launches, bwd.launches)
        with profiling.recording() as rec:
            out = model.forward_train(data)
        out["loss"].backward()
        torch.cuda.synchronize()
        assert (fwd.launches - before[0], bwd.launches - before[1]) == ((8, 8) if use_kernels else (0, 0))
        assert profiling.norm_use(rec) == (0, 2 * 4 + 2 * 2)   # under grad no norm takes the fused kernel
        grads.append((out["loss"].item(), {n_: p.grad.float().clone() for n_, p in model.named_parameters()
                                           if p.grad is not None}))
    (lk, gk), (lp, gp) = grads
    assert gk.keys() == gp.keys()
    if compute_dtype == "float32":
        assert lk == pytest.approx(lp, rel=1e-4)
        for name, g in gk.items():
            torch.testing.assert_close(g, gp[name], rtol=1e-4, atol=1e-6, msg=name)
        return
    assert lk == pytest.approx(lp, rel=1e-2)
    zero = _zero_grad_leaves(model)
    for name, g in gk.items():
        assert torch.isfinite(g).all(), name
        if not zero.search(name):
            cos = torch.nn.functional.cosine_similarity(g.flatten(), gp[name].flatten(), dim=0).item()
            assert cos >= 0.99, (name, cos)


@pytest.mark.cuda
def test_superpoint_on_the_card_matches_the_cpu(cuda_device):
    """SuperPoint at fp32 (cuDNN's TF32 off) on the card against the same
    module on the CPU: dense scores and descriptors within rtol 1e-4 / atol
    1e-5, keypoints by the margin rule; bf16 against fp32 on the card by the
    same rule with an overlap of at least 0.85."""
    from impx_torch.models.superpoint import SuperPoint, compare_extractions

    cpu = SuperPoint(device="cpu", seed=3)
    card = SuperPoint(device=cuda_device, seed=3)
    img = np.random.RandomState(4).rand(1, 120, 160).astype(np.float32)
    (sc, dc), (sg, dg) = cpu.backbone(img), card.backbone(img)
    torch.testing.assert_close(sg.cpu(), sc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dg.cpu(), dc, rtol=1e-4, atol=1e-5)
    margin = float((sg.cpu() - sc).abs().max())
    cmp = compare_extractions(card(img, max_keypoints=256), cpu(img, max_keypoints=256), margin)
    assert cmp["overlap"] >= 0.85 and not cmp["unexplained"], cmp
    s16, _ = card.backbone(img, compute_dtype=torch.bfloat16)
    margin16 = float((s16 - sg).abs().max())
    cmp = compare_extractions(card(img, max_keypoints=256),
                              card(img, compute_dtype=torch.bfloat16, max_keypoints=256), margin16)
    assert cmp["overlap"] >= 0.85 and not cmp["unexplained"] and cmp["min_cosine"] > 0.995, cmp


@pytest.mark.cuda
@pytest.mark.parametrize("feature,method", [("sift", "IMP"), ("spp", "EIMP")])
def test_demo_launches_the_kernels(cuda_device, tmp_path, feature, method):
    """The demo on the card: one produce_matches call of the 15-layer matcher
    launches kernel 1 on every layer (IMP: 30, and kernel 2 once; EIMP: the
    pooling iterations' layers through kernel 4, whose row lse kernel 6 takes)."""
    import cv2

    from impx_torch import demo
    from impx_torch.models.superpoint import SuperPoint

    rs = np.random.RandomState(5)
    img = cv2.GaussianBlur((rs.rand(240, 360) * 255).astype(np.uint8), (0, 0), 2.0)
    cv2.imwrite(str(tmp_path / "a.png"), img[:, :320])
    cv2.imwrite(str(tmp_path / "b.png"), img[:, 12:332])
    torch.save(SuperPoint(device="cpu").state_dict(), tmp_path / "sp.pth")
    kernels = (mha_fused, mha_fused_lse, attention_key_mass, sinkhorn_fused_stats)
    before = [fn.launches for fn in kernels]
    out = demo.main(["--image0", str(tmp_path / "a.png"), "--image1", str(tmp_path / "b.png"),
                     "--feature", feature, "--matching_method", method, "--sp_weights", str(tmp_path / "sp.pth"),
                     "--fx", "300", "--output", str(tmp_path / "m.png")])
    launches = [fn.launches - b for fn, b in zip(kernels, before)]
    assert (tmp_path / "m.png").stat().st_size > 0 and len(out["matches"]) > 0
    if method == "IMP":
        assert launches == [30, 0, 0, 1]
    else:
        assert launches[0] + launches[1] == 30 and launches[1] == launches[2] > 0 and launches[3] == 15


# the MLP block's epilogue (impx_torch/csrc/norm.cu) against its plain
# version on the card. fp32: the moments are summed in another order, so y
# moves by a few fp32 ulps (a fully masked image scales by 1/sqrt(eps), about
# 32). bf16: both sides round y and the activation's output to bf16, so a
# rounding flips now and then by one bf16 ulp (2^-8 relative)
NORM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2 ** -7, atol=1e-2)}
NORM_MASKS = ["none", "padded", "random", "fully-masked", "count-1"]


def norm_inputs(device, dtype, r, n, c, mask_kind, seed=0):
    """A product [r, n, c] with a per-channel offset and scale (so the bias
    and the centring matter), its bias and a mask of `mask_kind`: the first
    two thirds valid (padded), a random half, no token of image 1 valid, or
    one token of each image."""
    rs = np.random.RandomState(seed)
    x = rs.randn(r, n, c) * rs.uniform(0.5, 3.0, c) + rs.uniform(-2.0, 2.0, c)
    bias = rs.uniform(-1.0, 1.0, c)
    mask = {"none": None, "padded": np.arange(n)[None].repeat(r, 0) < 2 * n // 3,
            "random": rs.rand(r, n) < 0.5, "fully-masked": rs.rand(r, n) < 0.7,
            "count-1": np.eye(r, n, k=min(3, n - 1), dtype=bool)}[mask_kind]
    if mask_kind == "fully-masked":
        mask[min(1, r - 1)] = False
    x, bias = (torch.from_numpy(a).to(device, dtype) for a in (x, bias))
    return x, bias, None if mask is None else torch.from_numpy(mask).to(device)


def _check_norm(device, dtype, r, n, c, mask_kind, ac_fn):
    from impx_torch.ops.kernels.norm import norm_act, norm_act_reference

    x, bias, mask = norm_inputs(device, dtype, r, n, c, mask_kind)
    before = norm_act.launches
    with torch.no_grad():
        out = norm_act(x, bias, mask, ac_fn)
        again = norm_act(x, bias, mask, ac_fn)
        ref = norm_act_reference(x, bias, mask, ac_fn)
    torch.cuda.synchronize()
    assert norm_act.launches - before == 2
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, again)   # the same bits on every call
    torch.testing.assert_close(out.float(), ref.float(), **NORM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("ac_fn", ["relu", "gelu", "lrelu"])
@pytest.mark.parametrize("mask_kind", NORM_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_norm_kernel_matches_plain(cuda_device, dtype, mask_kind, ac_fn):
    _check_norm(cuda_device, dtype, 4, 333, 64, mask_kind, ac_fn)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("n", [333, 2000, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_norm_kernel_at_the_matchers_widths(cuda_device, dtype, n, c):
    """Token counts that no cluster split divides, at the encoder's and the
    layers' widths (C = 32 to 512), masked at random."""
    _check_norm(cuda_device, dtype, 3, n, c, "random", "relu")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_norm_kernel_at_eight_channel_slices(cuda_device, dtype, c):
    """Widths that only a slice of 8 channels divides (tensor parallelism
    over 4 ranks leaves the encoder's first block 32 / 4)."""
    _check_norm(cuda_device, dtype, 3, 2000, c, "random", "gelu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.float32, 60000), (torch.bfloat16, 110000)], ids=["fp32", "bf16"])
def test_norm_kernel_beyond_shared_memory(cuda_device, dtype, n):
    """Token counts whose rows overflow a CTA's shared memory at C = 512 (the
    kernel then reads them from device memory in each pass), padded."""
    _check_norm(cuda_device, dtype, 2, n, 512, "padded", "relu")


@pytest.mark.cuda
def test_norm_kernel_raises_for_what_it_does_not_take(cuda_device):
    """Under use_kernels and no grad mlp_apply takes the op on a CUDA
    tensor whatever the shape: a width no slice divides raises, and so does
    a float mask; with use_kernels=False the chain runs."""
    from impx_torch.ops.mlp import mlp_apply

    x = torch.randn(2, 50, 8, device=cuda_device)
    blocks = [(torch.randn(8, 20, device=cuda_device), torch.randn(20, device=cuda_device)),
              (torch.randn(20, 8, device=cuda_device), torch.randn(8, device=cuda_device))]
    mask = torch.ones(2, 50, dtype=torch.bool, device=cuda_device)
    with torch.no_grad():
        with pytest.raises(ValueError):
            mlp_apply(blocks, x, mask=mask, use_kernels=True)
        blocks[0] = (torch.randn(8, 32, device=cuda_device), torch.randn(32, device=cuda_device))
        blocks[1] = (torch.randn(32, 8, device=cuda_device), torch.randn(8, device=cuda_device))
        with pytest.raises(ValueError):
            mlp_apply(blocks, x, mask=mask.float(), use_kernels=True)
        assert mlp_apply(blocks, x, mask=mask.float(), use_kernels=False).shape == (2, 50, 8)


def _norm_gaps(out, ref, valid0):
    """The benchmark's agreement numbers of one call against the plain path:
    the share of valid rows whose indices0 differ, and the RMS gap of
    mscores0 over the rows both sides match to the same keypoint."""
    idx, ridx = out["indices0"][-1], ref["indices0"][-1]
    same = (idx == ridx) & (idx >= 0) & valid0
    mismatch = ((idx != ridx) & valid0).sum().item() / valid0.sum().item()
    gap = (out["mscores0"][-1] - ref["mscores0"][-1])[same]
    return mismatch, gap.pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["IMP", "EIMP"])
def test_matcher_with_the_norm_kernel_within_the_benchmark_limits(cuda_device, method):
    """The eval config (15 layers, D = 256, fp32) on pairs of 2000 slots,
    1700-2000 valid, descriptors x16 so that random weights match, as the
    benchmark's cells (IMP 4 pairs; EIMP 16, its compaction and dustbin
    score): every norm through the kernel (38 of 38 for IMP), and the kernel
    path within the
    benchmark's limits of the plain path: IMP `idx_mismatch` 2.5e-4 and
    `mscore_rms` 5e-4 (imp_match_yfcc); EIMP `idx_mismatch` 1e-4 and the
    keep masks' `keep_mismatch` 6e-5 (eimp_match_compact)."""
    from impx_torch.data.synthetic_device import synthesize_feed_device
    from impx_torch.ops.kernels.norm import norm_act
    from impx_torch.tools import profiling

    b, n = (4 if method == "IMP" else 16), 2000
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    feed, _, _ = synthesize_feed_device(gen, b, n, 256, device=cuda_device)
    feed = {k: feed[k] for k in ("descriptors0", "descriptors1", "norm_keypoints0", "norm_keypoints1",
                                 "scores0", "scores1", "valid0", "valid1")}
    for k in ("descriptors0", "descriptors1"):
        feed[k] = feed[k] * 16
    counts = torch.linspace(1700, 2000, b, device=cuda_device).round()
    for k in ("valid0", "valid1"):
        feed[k] = torch.arange(n, device=cuda_device)[None] < counts[:, None]
    cfg = MatcherConfig.eval_config("spp", 15)
    if method == "EIMP":
        import dataclasses

        cfg = dataclasses.replace(cfg, first_it_to_update=2, compaction=((4, 1024), (8, 512), (12, 256)))
        model = AdaGMN(cfg, device=cuda_device, seed=0)
        model.bin_score.data.fill_(9.0)
    else:
        model = DGNNS(cfg, device=cuda_device, seed=0)
    call = lambda: model.produce_matches(feed, p=0.2, only_last=True, with_scores=False)  # noqa: E731
    before = norm_act.launches
    with profiling.recording() as rec:
        out = call()
    taken, norms_ = profiling.norm_use(rec)
    assert taken == norms_ and norm_act.launches - before == taken
    if method == "IMP":
        assert taken == 38
    model.use_kernels = False
    ref = call()
    mismatch, rms = _norm_gaps(out, ref, feed["valid0"])
    if method == "IMP":
        assert mismatch <= 2.5e-4 and rms <= 5e-4, (mismatch, rms)
        return
    keep = torch.cat([(out[f"keep{i}"] != ref[f"keep{i}"])[feed[f"valid{i}"]] for i in (0, 1)])
    assert mismatch <= 1e-4 and keep.float().mean().item() <= 6e-5, (mismatch, keep.float().mean().item())
