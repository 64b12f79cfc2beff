"""The persistent design of kernels 2 and 7 (impx_torch/csrc/sinkhorn.cu,
log_sinkhorn.cu, csrc/persistent.cuh), emulated in plain PyTorch on the CPU.

The kernels spread the B * (N+1) dustbin-padded rows of the plan (or Z) over
a cooperative grid: with B pairs and G CTAs on the card, each pair gets
min(G / B, N+1) CTAs, each a contiguous block of its rows (whole pairs per
CTA when B > G). Per iteration each CTA forms u for its rows and its own
column partials over them (sums for kernel 2; an online (max, sum) in row
order for kernel 7; eight columns a thread, the last, partial round of
columns splitting each column's rows over gs threads; the dustbin column by
one warp), and each CTA then reduces a slice of its pair's columns
over the pair's slots in a fixed order: the slots q, q + gs, q + 2 gs, ...
in turn for each of gs threads, then a butterfly over the gs threads (gs a
power of two up to 32 from the slice's width); kernel 7 merges the result
into a log-sum-exp that starts from (-1e30, 1). The statistics come from the
same rows: max0, idx0 (and rowmass) by row, and per-slot column partials
(best, arg, mass) merged over the slots (the argmax by the larger value,
then the lower index: a total order).

These tests settle that order of work before the kernels meet the card:
against impx's Pallas kernels in interpret mode and against the port's plain
versions, at chip_smoke.py's limits (SINK_RTOL, SINK_ATOL, IDX_FLIP_MAX;
LOG_RTOL, LOG_ATOL, LOG_INVALID_ATOL), for 1, 7 and 132 CTAs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import IDX_FLIP_MAX, LOG_ATOL, LOG_INVALID_ATOL, LOG_RTOL, SINK_ATOL, SINK_RTOL
from impx.ops.pallas.log_sinkhorn import log_sinkhorn_fused_stats as jax_log_stats
from impx.ops.pallas.sinkhorn import sinkhorn_fused_stats as jax_stats
from impx_torch.ops.kernels.log_sinkhorn import log_sinkhorn_stats_reference
from impx_torch.ops.kernels.sinkhorn import plan_dtype, sinkhorn_stats_reference
from impx_torch.ops.sinkhorn import EPS, NEG, log_marginals, marginals, masked_scores
from test_torch_kernels import sinkhorn_case

THREADS = 512                 # a CTA, as persistent.cuh's kThreads
SMEM_MAX = 232448             # the H100's opt-in shared memory a block
SCRATCH = 64                  # persistent.cuh's kScratch
CTAS = [1, 7, 132]

# (b, n, m, n0, n1): the fp32 rule, the bf16 rule at N = 1280, heavily
# masked, and fewer rows than CTAs
CASES = [
    (2, 256, 256, [200, 256], [180, 256]),
    (1, 1280, 1280, [1100], [1200]),
    (2, 512, 512, [30, 512], [25, 512]),
    (1, 100, 100, [90], [80]),
]
CASE_IDS = ["fp32-rule", "bf16-rule-1280", "heavily-masked", "fewer-rows-than-ctas"]
@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulation runs thousands of small ops: across threads they cost
    the same time alone and many times more beside other test processes,
    so this module runs torch on one thread, as tests/test_torch_logot.py."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# kernel 7 without alignment rows under the bf16 rule (N + 1 = 32): impx
# turns an invalid column to NaN there, the port stays finite
NO_ALIGNMENT = (1, 31, 49152, [31], [40000])


# ------------------------------------------------------------------ schedule
def make_schedule(b: int, n: int, m: int, max_ctas: int, elem_bytes: int) -> dict:
    """persistent.cuh:make_sched."""
    rows, cols, stride = n + 1, m + 1, -(-(m + 1) // 8) * 8
    if b <= max_ctas:
        per_pair, ppc = min(max_ctas // b, rows), 1
        grid, rows_max = b * per_pair, -(-rows // per_pair)
    else:
        per_pair, ppc = 1, -(-b // max_ctas)
        grid, rows_max = -(-b // ppc), ppc * rows
    fixed = 4 * stride + 16 * rows_max + 8 * ppc + 4 * SCRATCH + 4 * -(-stride // 32)
    cap = min(rows_max, (SMEM_MAX - fixed) // (stride * elem_bytes))
    s = dict(batch=b, rows=rows, cols=cols, grid=grid, per_pair=per_pair, ppc=ppc, cap=cap,
             stride=stride)
    s["ranges"] = [cta_range(s, g) for g in range(grid)]
    s["overflow"] = sum(max(0, hi - lo - cap) for lo, hi in s["ranges"])
    return s


def cta_range(s: dict, g: int) -> tuple[int, int]:
    """persistent.cuh:cta_range: CTA g's flattened rows [lo, hi)."""
    rows = s["rows"]
    if s["ppc"] == 1:
        p, k = divmod(g, s["per_pair"])
        return p * rows + k * rows // s["per_pair"], p * rows + (k + 1) * rows // s["per_pair"]
    p0 = g * s["ppc"]
    return p0 * rows, min(s["batch"], p0 + s["ppc"]) * rows


def pair_blocks(s: dict):
    """Each slot's (pair, part, pair-local rows [i0, i1)), slot = pair *
    per_pair + part."""
    rows = s["rows"]
    for g, (lo, hi) in enumerate(s["ranges"]):
        k = g % s["per_pair"] if s["ppc"] == 1 else 0
        for p in range(lo // rows, (hi - 1) // rows + 1):
            yield p, k, max(lo, p * rows) - p * rows, min(hi, (p + 1) * rows) - p * rows


def col_slices(s: dict, width: int | None = None):
    """Each part k's column slice [c0, c1) (of the first `width` columns)
    and its threads a column."""
    for k in range(s["per_pair"]):
        c0, c1 = k * s["cols"] // s["per_pair"], (k + 1) * s["cols"] // s["per_pair"]
        c1 = min(c1, width or c1)
        yield k, c0, c1, group_size(max(c1 - c0, 1))


def group_size(ncols: int) -> int:
    """persistent.cuh:group_size: threads a column in a column pass."""
    gs = 1
    while gs < 32 and 2 * gs * ncols <= THREADS:
        gs *= 2
    return gs


def reduce_columns(parts: list, s: dict, merge, width: int):
    """Every column of a pair reduced over the pair's slots as its CTA does
    it (`merge_slots` with its slice's gs); parts[q] is slot q's partial, a
    tuple of [width] tensors. The slices that share a gs are reduced
    together."""
    by_gs: dict[int, list] = {}
    for _, c0, c1, gs in col_slices(s, width):
        by_gs.setdefault(gs, []).extend(range(c0, c1))
    out = [torch.empty_like(x) for x in parts[0]]
    for gs, cols in by_gs.items():
        cols = torch.tensor(cols, dtype=torch.long)
        merged = merge_slots([tuple(x[cols] for x in part) for part in parts], gs, merge)
        for o, x in zip(out, merged):
            o[cols] = x
    return out


def merge_slots(parts: list, gs: int, merge):
    """The column reduce's fixed order over a pair's slots: thread q merges
    slots q, q + gs, ... in turn, then a butterfly over the gs threads;
    thread 0's result. `parts` holds one partial (a tuple of tensors) a
    slot, `merge(a, b)` merges two."""
    subs = []
    for q in range(gs):
        acc = None
        for part in parts[q::gs]:
            acc = part if acc is None else merge(acc, part)
        subs.append(acc)
    off = gs // 2
    while off:
        subs = [x if subs[q ^ off] is None else (subs[q ^ off] if x is None else merge(x, subs[q ^ off]))
                for q, x in enumerate(subs)]
        off //= 2
    return subs[0]


# ------------------------------------------------------------------ kernel 2
def _rnd(x, dtype):
    return x.to(dtype).float()


def emulate_sinkhorn(dist, bin_, iterations, valid0, valid1, ctas):
    b, n, m = dist.shape
    pd = plan_dtype(n, m)
    s = make_schedule(b, n, m, ctas, pd.itemsize)
    f0, f1 = valid0.float(), valid1.float()
    r, c = marginals(f0, f1)
    plan = torch.softmax(masked_scores(dist, bin_, valid0, valid1)[:, :n], dim=2)
    inv = 1.0 / c[:, m:]
    dust = torch.cat([torch.where(f1 > 0, inv, 0.0), inv], dim=1)
    plan = _rnd(torch.cat([plan, dust[:, None, :]], dim=1), pd)
    blocks = list(pair_blocks(s))
    v = torch.ones_like(c)
    for _ in range(iterations):
        u = r / ((plan * _rnd(v, pd)[:, None, :]).sum(dim=2) + EPS)     # one warp a row
        parts = {(p, k): (plan[p, i0:i1] * _rnd(u[p, i0:i1], pd)[:, None]).sum(dim=0)
                 for p, k, i0, i1 in blocks}
        total = torch.stack([
            reduce_columns([(parts[p, q],) for q in range(s["per_pair"])], s,
                           lambda x, y: (x[0] + y[0],), m + 1)[0] for p in range(b)])
        v = c / (total + EPS)
    ok = valid0[:, :, None] & valid1[:, None, :]
    val = plan[:, :n, :m] * u[:, :n, None] * v[:, None, :m]
    filled, masked = torch.where(ok, val, -1.0), torch.where(ok, val, 0.0)
    idx1, colmass = torch.empty((b, m), dtype=torch.int32), torch.empty((b, m))
    best = {}
    for p, k, i0, i1 in blocks:
        i1 = min(i1, n)                                            # interior rows
        seg = filled[p, i0:i1]
        if i1 > i0:
            bv, ba = seg.max(dim=0)
            best[p, k] = (bv, ba + i0, masked[p, i0:i1].sum(dim=0))
        else:
            best[p, k] = (torch.full((m,), -1.0), torch.zeros(m, dtype=torch.long), torch.zeros(m))
    for p in range(b):
        _, ba, mass = reduce_columns([best[p, q] for q in range(s["per_pair"])], s, _arg_merge, m)
        idx1[p], colmass[p] = ba.to(torch.int32), mass
    return {"u": u, "v": v, "max0": filled.amax(dim=2), "idx0": filled.argmax(dim=2).to(torch.int32),
            "idx1": idx1, "rowmass": masked.sum(dim=2), "colmass": colmass}


def _arg_merge(x, y):
    """(best, arg, mass) merged: the larger value, then the lower index; masses
    summed."""
    take = (y[0] > x[0]) | ((y[0] == x[0]) & (y[1] < x[1]))
    return torch.where(take, y[0], x[0]), torch.where(take, y[1], x[1]), *(a + b_ for a, b_ in zip(x[2:], y[2:]))


# ------------------------------------------------------------------ kernel 7
def _lse_merge(a, b):
    """persistent.cuh:lse_merge, elementwise: (mx, s) merged with (omx, os)."""
    (mx, s), (omx, os) = a, b
    up = omx > mx
    merged = torch.where(up, s * torch.exp(mx - omx) + os, s + os * torch.exp(omx - mx))
    keep = os == 0
    return torch.where(keep | ~up, mx, omx), torch.where(keep, s, merged)


def lse_groups(x, gs: int):
    """Online log-sum-exp of the rows of x [rows, w] as gs threads take them
    (thread q rows q, q + gs, ... in turn), then a butterfly over the
    threads; thread 0's (max, sum)."""
    w = x.shape[1]
    mx, sm = torch.full((gs, w), -torch.inf), torch.zeros(gs, w)
    for k in range(0, x.shape[0], gs):
        rows = x[k:k + gs]
        t = rows.shape[0]
        mx[:t], sm[:t] = _lse_merge((mx[:t], sm[:t]), (rows, torch.ones_like(rows)))
    off = gs // 2
    while off:
        partner = torch.arange(gs) ^ off
        mx, sm = _lse_merge((mx, sm), (mx[partner], sm[partner]))
        off //= 2
    return mx[0], sm[0]


def column_partials_lse(x):
    """A CTA's column partials of kernel 7 over its rows' terms x [rows, M+1]:
    the interior columns 8 a thread in rounds of THREADS, the last round's
    split over gs threads each; the dustbin column by one warp (32
    threads)."""
    cols = x.shape[1]
    m = cols - 1
    mx, sm = torch.full((cols,), -torch.inf), torch.zeros(cols)
    octs, base = -(-m // 8), 0
    while base < octs:
        gs = group_size(octs - base)
        span = slice(8 * base, min(m, 8 * (base + THREADS // gs)))
        mx[span], sm[span] = lse_groups(x[:, span], gs)
        base += THREADS // gs
    mx[m:], sm[m:] = lse_groups(x[:, m:], 32)
    return mx, sm


def emulate_log_sinkhorn(dist, bin_, iterations, valid0, valid1, ctas):
    b, n, m = dist.shape
    zd = plan_dtype(n, m)
    s = make_schedule(b, n, m, ctas, zd.itemsize)
    log_mu, log_nu, norm = log_marginals(valid0.float(), valid1.float())
    z = masked_scores(dist, bin_, valid0, valid1).to(zd).float()
    blocks = list(pair_blocks(s))
    v = torch.zeros_like(log_nu)
    for _ in range(iterations):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)           # one warp a row
        parts = {(p, k): column_partials_lse(z[p, i0:i1] + u[p, i0:i1, None]) for p, k, i0, i1 in blocks}
        v = torch.empty_like(log_nu)
        for p in range(b):
            mx, sm = reduce_columns([parts[p, q] for q in range(s["per_pair"])], s, _lse_merge, m + 1)
            cm, cs = _lse_merge((torch.full_like(mx, NEG), torch.ones_like(sm)), (mx, sm))
            v[p] = log_nu[p] - (cm + torch.log(cs))
    ok = valid0[:, :, None] & valid1[:, None, :]
    filled = torch.where(ok, z[:, :n, :m] + u[:, :n, None] + v[:, None, :m] - norm[:, :, None], NEG)
    idx1 = torch.empty((b, m), dtype=torch.int32)
    best = {}
    for p, k, i0, i1 in blocks:
        i1 = min(i1, n)
        if i1 > i0:
            bv, ba = filled[p, i0:i1].max(dim=0)
            best[p, k] = (bv, ba + i0)
        else:
            best[p, k] = (torch.full((m,), NEG), torch.zeros(m, dtype=torch.long))
    for p in range(b):
        idx1[p] = reduce_columns([best[p, q] for q in range(s["per_pair"])], s, _arg_merge, m)[1].to(torch.int32)
    return {"u": u, "v": v, "max0": filled.amax(dim=2), "idx0": filled.argmax(dim=2).to(torch.int32),
            "idx1": idx1}


# ------------------------------------------------------------------ helpers
@functools.lru_cache(maxsize=None)
def _inputs(case):
    b, n, m, n0, n1 = case
    dist, bin_, valid0, valid1 = sinkhorn_case(b, n, m, list(n0), list(n1))
    return dist, bin_, valid0, valid1


@functools.lru_cache(maxsize=None)
def _impx(kernel: str, case):
    dist, bin_, valid0, valid1 = _inputs(case)
    fn = jax_stats if kernel == "sinkhorn" else jax_log_stats
    out = fn(jnp.asarray(dist), jnp.asarray(bin_), 20, jnp.asarray(valid0), jnp.asarray(valid1),
             interpret=True)
    return {k: torch.from_numpy(np.array(x)) for k, x in out.items()}


def _torch_inputs(case):
    dist, bin_, valid0, valid1 = _inputs(case)
    return torch.from_numpy(dist), torch.tensor(bin_), torch.from_numpy(valid0), torch.from_numpy(valid1)


def _key(case):
    b, n, m, n0, n1 = case
    return b, n, m, tuple(n0), tuple(n1)


def _assert_sinkhorn_close(out, ref, what):
    for key in ("u", "v", "max0", "rowmass", "colmass"):
        err = (out[key] - ref[key]).abs()
        assert bool((err <= SINK_ATOL + SINK_RTOL * ref[key].abs()).all()), (what, key, err.max().item())
    for key in ("idx0", "idx1"):
        assert (out[key] != ref[key]).float().mean().item() <= IDX_FLIP_MAX, (what, key)


def _assert_log_close(out, ref, valid0, valid1, what):
    b = valid0.shape[0]
    one = torch.ones((b, 1), dtype=torch.bool)
    for key, ok in (("u", torch.cat([valid0, one], 1)), ("v", torch.cat([valid1, one], 1)),
                    ("max0", torch.ones_like(valid0))):
        assert bool(torch.isfinite(out[key]).all()), (what, key)
        err = (out[key] - ref[key]).abs()
        assert bool((err[ok] <= LOG_ATOL + LOG_RTOL * ref[key][ok].abs()).all()), \
            (what, key, err[ok].max().item())
        assert bool((err[~ok] <= LOG_INVALID_ATOL).all()), (what, key)
    for key in ("idx0", "idx1"):
        assert (out[key] != ref[key]).float().mean().item() <= IDX_FLIP_MAX, (what, key)


# ------------------------------------------------------------------ tests
def test_schedule_at_the_main_shape():
    """B = 4, N = M = 2048 under the bf16 rule on 132 CTAs: 33 CTAs a pair of
    62 or 63 rows, 54 of them kept in shared memory, the rest (4.4 MB) in
    the overflow buffer; the fp32 rule's 1024-keypoint buckets fit whole."""
    s = make_schedule(4, 2048, 2048, 132, 2)
    assert (s["grid"], s["per_pair"], s["cap"]) == (132, 33, 54)
    sizes = {hi - lo for lo, hi in s["ranges"]}
    assert sizes == {62, 63}
    assert s["overflow"] == sum(hi - lo - 54 for lo, hi in s["ranges"])
    assert 4.3e6 < s["overflow"] * s["stride"] * 2 < 4.5e6
    assert make_schedule(4, 1024, 1024, 132, 4)["overflow"] == 0


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("b,n,m,n0,n1", [(4, 2048, 2048, [0] * 4, [0] * 4), (8, 2048, 2048, [0] * 8, [0] * 8),
                                         (1, 100, 100, [0], [0]), (300, 64, 64, [0] * 300, [0] * 300)],
                         ids=["4x2048", "8x2048", "1x100", "300x64"])
def test_schedule_covers_every_row_once(ctas, b, n, m, n0, n1):
    """The CTAs' row blocks tile the flattened rows in order, every pair's
    slots hold its rows, and the column slices tile each pair's columns."""
    s = make_schedule(b, n, m, ctas, 2)
    assert s["grid"] <= ctas
    assert s["ranges"][0][0] == 0 and s["ranges"][-1][1] == b * (n + 1)
    assert all(a[1] == c[0] for a, c in zip(s["ranges"], s["ranges"][1:]))
    assert all(hi > lo for lo, hi in s["ranges"])
    rows = {}
    for p, k, i0, i1 in pair_blocks(s):
        rows.setdefault(p, []).append((i0, i1))
    assert sorted(rows) == list(range(b))
    assert all(sum(i1 - i0 for i0, i1 in blocks) == n + 1 for blocks in rows.values())
    cols = sorted((c0, c1) for _, c0, c1, _ in col_slices(s))
    assert sorted(reduce_columns([(torch.arange(m + 1.0),)] * s["per_pair"], s,
                                 lambda x, y: (torch.maximum(x[0], y[0]),), m + 1)[0].tolist()) \
        == list(range(m + 1))
    assert cols[0][0] == 0 and cols[-1][1] == m + 1
    assert all(a[1] == c[0] for a, c in zip(cols, cols[1:]))


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sinkhorn_design_matches_impx_and_plain(ctas, case):
    case = _key(case)
    args = _torch_inputs(case)
    out = emulate_sinkhorn(*args[:2], 20, *args[2:], ctas)
    _assert_sinkhorn_close(out, _impx("sinkhorn", case), "impx")
    _assert_sinkhorn_close(out, sinkhorn_stats_reference(*args[:2], 20, *args[2:]), "plain")


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_log_sinkhorn_design_matches_impx_and_plain(ctas, case):
    case = _key(case)
    args = _torch_inputs(case)
    out = emulate_log_sinkhorn(*args[:2], 20, *args[2:], ctas)
    _assert_log_close(out, _impx("log_sinkhorn", case), args[2], args[3], "impx")
    _assert_log_close(out, log_sinkhorn_stats_reference(*args[:2], 20, *args[2:]), args[2], args[3], "plain")


@pytest.mark.parametrize("ctas", CTAS)
def test_log_sinkhorn_design_without_alignment_rows_stays_finite(ctas):
    """N = 31, M = 49,152 under the bf16 Z rule: impx's kernel turns the pair
    to NaN; the design stays finite, equals the plain version, and equals
    impx on the same pair with one padded row added (which changes no valid
    entry)."""
    b, n, m, n0, n1 = _key(NO_ALIGNMENT)
    padded = (b, n + 1, m, n0, n1)              # row n is padded (n0 = 31)
    dist, bin_, valid0, valid1 = _torch_inputs(padded)
    args = (dist[:, :n].contiguous(), bin_, valid0[:, :n].contiguous(), valid1)
    assert plan_dtype(n, m) == torch.bfloat16
    out = emulate_log_sinkhorn(args[0], bin_, 20, args[2], args[3], ctas)
    assert all(bool(torch.isfinite(x.float()).all()) for x in out.values())
    _assert_log_close(out, log_sinkhorn_stats_reference(args[0], bin_, 20, args[2], args[3]),
                      args[2], args[3], "plain")
    ref = dict(_impx("log_sinkhorn", padded))
    ref["u"] = torch.cat([ref["u"][:, :n], ref["u"][:, n + 1:]], dim=1)   # drop the added row
    ref["max0"], ref["idx0"] = ref["max0"][:, :n], ref["idx0"][:, :n]
    _assert_log_close(out, ref, args[2], args[3], "impx")
