"""The MLP block's fused epilogue (impx_torch/ops/kernels/norm.py, kernel
csrc/norm.cu) on the CPU: the kernel's order of sums emulated in PyTorch
against the InstanceNorm in float64, the op's CPU body against the chain it
replaces bit for bit, and where mlp_apply takes the op."""
import numpy as np
import pytest
import torch

from impx_torch.ops import mlp, norms
from impx_torch.ops.kernels import norm as norm_kernel
from impx_torch.ops.kernels.norm import CLUSTER, kernel_takes, norm_act, norm_act_reference, slice_for
from impx_torch.tools import profiling

THREADS = 256   # norm.cu's kThreads
MASKS = ["none", "padded", "random", "fully-masked", "count-1"]
ACTS = ["relu", "gelu", "lrelu"]


def _inputs(dtype, r, n, c, mask_kind, seed=0):
    """A product with per-channel offsets and scales, its bias and a mask
    (as tests/test_torch_kernels.py:norm_inputs, on the CPU)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(r, n, c) * rs.uniform(0.5, 3.0, c) + rs.uniform(-2.0, 2.0, c)
    bias = rs.uniform(-1.0, 1.0, c)
    mask = {"none": None, "padded": np.arange(n)[None].repeat(r, 0) < 2 * n // 3,
            "random": rs.rand(r, n) < 0.5, "fully-masked": rs.rand(r, n) < 0.7,
            "count-1": np.eye(r, n, k=min(3, n - 1), dtype=bool)}[mask_kind]
    if mask_kind == "fully-masked":
        mask[min(1, r - 1)] = False
    x, bias = (torch.from_numpy(a).to(dtype) for a in (x, bias))
    return x, bias, None if mask is None else torch.from_numpy(mask)


def _in_order(parts):
    """parts[0] + parts[1] + ... in fp32, one add at a time."""
    total = parts[0].clone()
    for p in parts[1:]:
        total = total + p
    return total


def kernel_order(x, bias, mask, ac_fn):
    """norm.cu's arithmetic in its order: the biased sum in x's dtype; each
    CTA's rows split over row lanes (a thread takes rows lane, lane + lanes,
    ... and adds them in turn), the lanes added in order, then the CLUSTER
    CTAs in rank order; mean = sum / max(count, 1); the centred sum of
    squares the same way; y = (s - mean) rsqrt(var + eps) rounded to x's
    dtype, the activation's output again."""
    r, n, c = x.shape
    s = (x + bias).float()
    valid = torch.ones(r, n, dtype=torch.bool) if mask is None else mask
    row_lanes = THREADS // (slice_for(n, c, x.element_size()) // (16 // x.element_size()))
    rows = -(-n // CLUSTER)

    def cluster_sum(v):   # [r, n, c] fp32 -> [r, c], in the kernel's order
        ranks = []
        for k in range(CLUSTER):
            chunk = v[:, k * rows:(k + 1) * rows]
            steps = -(-chunk.shape[1] // row_lanes)
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, steps * row_lanes - chunk.shape[1]))
            per_lane = _in_order(list(chunk.reshape(r, steps, row_lanes, -1).unbind(1)))
            ranks.append(_in_order(list(per_lane.unbind(1))))
        return _in_order(ranks)

    zero = torch.zeros(())
    count = cluster_sum(valid[..., None].float()).clamp_min(1.0)[:, None]
    mean = cluster_sum(torch.where(valid[..., None], s, zero))[:, None] / count
    var = cluster_sum(torch.where(valid[..., None], (s - mean) ** 2, zero))[:, None] / count
    y = ((s - mean) * torch.rsqrt(var + norms.EPS)).to(x.dtype)
    return mlp.activation(y, ac_fn)


def _float64(x, bias, mask, ac_fn):
    s = (x + bias).double()
    return mlp.activation(norms.instance_norm(s, mask=mask), ac_fn)


@pytest.mark.parametrize("ac_fn", ACTS)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_order_against_float64(dtype, mask_kind, ac_fn):
    """The kernel's sums, emulated, against the InstanceNorm in float64 of the
    same biased sum: fp32 within a few ulps of y (a fully masked image is s /
    sqrt(eps), about 32 s); bf16 within one bf16 rounding of y."""
    x, bias, mask = _inputs(dtype, 4, 333, 64, mask_kind)
    got, want = kernel_order(x, bias, mask, ac_fn).double(), _float64(x, bias, mask, ac_fn)
    tol = dict(rtol=2e-6, atol=2e-6) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-2)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("n", [333, 2000, 4096])
def test_kernel_order_at_the_matchers_widths(n, c):
    """Token counts that no split divides, at the encoder's and the layers'
    widths, masked at random: the emulated kernel lies as close to float64 as
    PyTorch's own fp32 InstanceNorm, within a factor of 4 and 1e-6."""
    x, bias, mask = _inputs(torch.float32, 2, n, c, "random", seed=n + c)
    want = _float64(x, bias, mask, "relu")
    err = (kernel_order(x, bias, mask, "relu").double() - want).abs().max().item()
    plain = (norm_act_reference(x, bias, mask, "relu").double() - want).abs().max().item()
    assert err <= 4 * plain + 1e-6, (err, plain)


def _old_chain(w, b, x, mask, ac_fn):
    """mlp_apply's first block as it was before the kernel: the dense block,
    the masked InstanceNorm in fp32, the activation in x's dtype."""
    x = mlp.dense_apply(w, b, x)
    return mlp.activation(norms.instance_norm(x.float(), mask=mask).to(x.dtype), ac_fn)


@pytest.mark.parametrize("ac_fn", ACTS)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_op_cpu_body_is_the_old_chain(dtype, mask_kind, ac_fn):
    """impx::norm_act on CPU tensors, through mlp_apply under no_grad, gives
    the old chain's output bit for bit."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(3, 40, 24)).to(dtype)
    w, w2 = (torch.from_numpy(rs.randn(*s) / 5).float() for s in ((24, 32), (32, 24)))
    b, b2 = (torch.from_numpy(rs.randn(c)).float() for c in (32, 24))
    _, _, mask = _inputs(dtype, 3, 40, 32, mask_kind)
    with torch.no_grad():
        got = mlp.mlp_apply([(w, b), (w2, b2)], x, ac_fn=ac_fn, mask=mask, use_kernels=True)
        ours = norm_act(torch.matmul(x, w.to(dtype)), b.to(dtype), mask, ac_fn)
    old = mlp.dense_apply(w2, b2, _old_chain(w, b, x, mask, ac_fn))
    assert torch.equal(ours, _old_chain(w, b, x, mask, ac_fn))
    assert torch.equal(got, old)


def _blocks(requires_grad=False):
    rs = np.random.RandomState(2)
    shapes = [(8, 16), (16, 32), (32, 8)]
    return [(torch.from_numpy(rs.randn(*s) / 4).float().requires_grad_(requires_grad),
             torch.from_numpy(rs.randn(s[1])).float().requires_grad_(requires_grad)) for s in shapes]


def _taken(monkeypatch, call):
    """(the counter's (taken, norms), the op's calls) over one call."""
    calls = []
    monkeypatch.setattr(mlp, "norm_act", lambda *a: calls.append(a) or norm_act(*a))
    with profiling.recording() as rec:
        call()
    return profiling.norm_use(rec), len(calls)


BN = [tuple(torch.ones(c) if i in (0, 3) else torch.zeros(c) for i in range(4)) for c in (16, 32)]
X = torch.from_numpy(np.random.RandomState(3).randn(2, 24, 8)).float()
MASK = torch.arange(24)[None].repeat(2, 1) < torch.tensor([[20], [24]])


@pytest.mark.parametrize("route,want", [
    ("no_grad", 2), ("inference_mode", 2), ("grad_off_leaves", 2), ("float_mask", 2), ("use_kernels_off", 0),
    ("grad", 0), ("x_requires_grad", 0), ("bn_running", 0), ("bn_batch", 0), ("seq_group", 0)])
def test_dispatch(monkeypatch, route, want):
    """mlp_apply takes the op for every norm under no_grad (or inference
    mode, or with grad on and nothing requiring it) with the InstanceNorm
    over this rank's tokens, whatever the shape or mask (on a CUDA tensor
    the op raises for what its kernel does not take; it never falls back to
    the chain unseen); use_kernels=False, grad through the blocks or
    through x, batch norm (running or batch statistics) and a sequence group
    keep the chain. The counter records each norm either way."""
    if route == "seq_group":   # the group's all-reduces, at one rank: the local sums
        plain = norms.instance_norm
        monkeypatch.setattr(mlp.norms, "instance_norm", lambda x, mask=None, group=None: plain(x, mask))
    kw = dict(ac_fn="relu", mask=MASK.float() if route == "float_mask" else MASK,
              use_kernels=route != "use_kernels_off")
    blocks, x = _blocks(requires_grad=route == "grad"), X.clone().requires_grad_(route == "x_requires_grad")
    if route.startswith("bn"):
        kw.update(batch_norms=BN, batch_stats=route == "bn_batch")
    if route == "seq_group":
        kw["seq_group"] = object()
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
               "float_mask": torch.no_grad}.get(route, torch.enable_grad)
    with context():
        (taken, norms_), calls = _taken(monkeypatch, lambda: mlp.mlp_apply(blocks, x, **kw))
    assert (taken, norms_, calls) == (want, 2, want)


def test_shapes_the_kernel_takes():
    """The shape rule: a cluster slice of at most 64 channels dividing C (the
    widest whose rows a CTA holds within 32 KiB, else the narrowest), any
    token count (rows beyond a CTA's shared memory are read from device
    memory), fp32 or bf16, a bool mask or none. The CUDA body raises for
    anything else, before any build, and returns an empty tensor for an
    empty one."""
    assert slice_for(2000, 512, 4) == 32 and slice_for(4096, 512, 4) == 16 and slice_for(2000, 32, 4) == 32
    assert slice_for(4096, 512, 2) == 32 and slice_for(2000, 24, 4) == 8 and slice_for(2000, 20, 4) is None
    assert slice_for(1000, 512, 4) == 64 and slice_for(8 * 1600, 512, 4) == 8
    assert slice_for(8 * 6400, 512, 4) == 8 and slice_for(8 * 6401, 512, 4) == 8
    x = torch.zeros(2, 100, 64)
    assert kernel_takes(x, None) and kernel_takes(x.bfloat16(), torch.ones(2, 100, dtype=torch.bool))
    assert kernel_takes(torch.zeros(2, 0, 64), None) and kernel_takes(torch.zeros(70000, 4, 8), None)
    assert not kernel_takes(x.half(), None) and not kernel_takes(x, torch.ones(2, 100))
    assert not kernel_takes(torch.zeros(2, 100, 20), None) and not kernel_takes(torch.zeros(100, 64), None)
    for bad in ((x.half(), torch.zeros(64).half(), None, "relu"), (x, torch.zeros(64), torch.ones(2, 100), "relu"),
                (torch.zeros(2, 100, 20), torch.zeros(20), None, "relu"), (x, torch.zeros(64), None, "tanh")):
        with pytest.raises(ValueError):
            norm_kernel._cuda(*bad)
    assert norm_kernel._cuda(torch.zeros(2, 0, 64), torch.zeros(64), None, "relu").shape == (2, 0, 64)
