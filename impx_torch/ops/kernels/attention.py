"""Masked multi-head attention, forward and backward, and the per-key
attention mass of EIMP pooling: the CUDA kernels' wrappers, their plain
PyTorch versions, and the two autograd Functions that pair them for training.

Replaces the TPU kernel impx/ops/pallas/attention.py:mha_fused (:203, kernel
`_attn_kernel` :49), which holds all of K and V of one (batch, head) on chip
and needs no online softmax. On the H100, bf16 K and V at N = 2048, dh = 64
take 512 KB, more than one SM's 227 KB of shared memory, so the kernel in
impx_torch/csrc/attention.cu tiles over keys with an online softmax.

What bounds it on the H100: the QK^T and P.V products (4 * N^2 * dh flops per
(batch, head)), against 989 TFLOP/s of bf16 tensor cores; the exponentials
take about as long on the special-function units, and q, k, v, o move a
third of that time's bytes. The design keeps scores and probabilities in
registers (never in device memory). bf16: one block per (batch*head, 128
queries), a producer warp keeping TMA loads of 64-key K and V tiles in flight
through a ring in shared memory, two consumer warpgroups running both
products as wgmma with fp32 accumulation, P fed to P.V from registers, and
the four warpgroups of two blocks on an SM overlapping one's exponentials
with the others' products. fp32 inputs take both products as wgmma in 3xTF32
(impx_torch/csrc/attention_tf32.cuh: each operand split into TF32 hi + lo,
three passes, about 2^-21 relative error a product), 128 queries a block,
K and V tiles through a cp.async ring and split once a block. Both read a
bool key mask in place; the wrapper hands them any other mask as its
entries > 0.

Semantics, as the TPU kernel: scores scaled by 1/sqrt(dh) before masking;
a key is valid where its mask entry is > 0 (True in a bool mask); invalid
keys get the finite -1e30 (a fully masked row gives uniform weights, never
NaN); fp32 softmax; P cast to the input dtype for P.V with fp32
accumulation; the division by the row sum comes after P.V.

Training (impx/models/fast.py:forward_train_scan) has two routes:
  * route A, `MhaFunction`: the forward `mha_fused` (kernel 1) and its VJP
    `mha_bwd` (kernel 3, `_mha_bwd_call` :137), which recomputes the softmax
    and takes fp32 operands for every product but QK^T; `mha_fused` itself is
    this Function whenever an input requires grad, as the TPU kernel's
    custom VJP (:183-199);
  * route B, `MhaLseFunction`: `mha_fused_lse` (kernel 4, :245), which also
    writes each row's log-sum-exp, and `mha_bwd_from_lse` (kernel 5, :336),
    which rebuilds p = exp(s - lse) and takes stream-dtype operands.
Both backward kernels live in impx_torch/csrc/attention_bwd.cu, two launches
a call (a dq launch, then a dk/dv launch), at bf16 on mma.sync and at fp32 on
wgmma in 3xTF32 as the fp32 forward; both read the bool key mask in place.

`attention_key_mass` replaces impx/ops/pallas/attention.py:attention_key_mass
(:422, kernel `_mass_kernel` :395), which carries one [Nk] sum across a
sequential (head, query-block) grid. impx_torch/csrc/attention_mass.cu takes
each query row's log-sum-exp, from the caller (EIMP's pooling layers run
kernel 4 on the same q, k and key mask) or from a row-lse launch of its own,
and sums p = exp(s - lse) over heads and queries in one pass: one CTA per
128 keys, the sum over queries in each thread's registers, a fixed order.

The inference kernels (1, 4 and 6) are `torch.library` ops (`_ops.py`),
`impx::mha_fwd`, `impx::mha_fwd_lse` and `impx::attention_key_mass`: a
CUDA implementation that launches the kernel, a CPU implementation that is
its plain version, and a fake implementation for the output shapes, so that
`torch.export` (impx_torch/tools/export.py) keeps them in its graph and an
exported call launches the same kernels as an eager one. The wrappers below
call through the ops; the autograd Functions of training launch the kernels
directly.
"""
from __future__ import annotations

import torch

from impx_torch.ops.kernels import _build, _ops
from impx_torch.tools.profiling import span

NEG = -1e30
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64)


def _valid(mask):
    """A mask as impx reads it (`mask.astype(float32) > 0`): a bool mask as it
    is, any other as its entries > 0."""
    return mask if mask.dtype == torch.bool else mask > 0


def _scores(q, k, key_mask):
    """fp32 scaled scores [B, H, Nq, Nk], masked keys at -1e30. Products of
    bf16 inputs are exact in fp32, so upcasting before the matmul is the TPU
    kernel's fp32 accumulation."""
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / dh ** 0.5)
    if key_mask is not None:
        s = torch.where(_valid(key_mask)[:, None, None, :], s, NEG)
    return s


def mha_reference(q, k, v, key_mask=None):
    """Plain version of kernel 1: q [B,H,Nq,dh], k/v [B,H,Nk,dh], key_mask
    [B,Nk] -> [B,H,Nq,dh] in q's dtype."""
    s = _scores(q, k, key_mask)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def mha_lse_reference(q, k, v, key_mask=None):
    """Plain version of kernel 4: (out as `mha_reference`, lse [B,H,Nq] fp32
    = row max + log(row sum); -1e30 on a fully masked row)."""
    s = _scores(q, k, key_mask)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


def mha_bwd_reference(q, k, v, key_mask, do):
    """Plain version of kernel 3 (impx/ops/pallas/attention.py:_attn_bwd_kernel
    :96): p recomputed as exp(s - max) / sum, dp = do v^T, delta =
    rowsum(dp * p), ds = p (dp - delta) scale; dq = ds k, dk = ds^T q,
    dv = p^T do with fp32 operands. Returns (dq, dk, dv) in the inputs' dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = _scores(q, k, key_mask)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    do32 = do.float()
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_bwd_from_lse_reference(q, k, v, key_mask, lse, o, do):
    """Plain version of kernel 5 (impx/ops/pallas/attention.py:
    _attn_bwd_lse_kernel :290): p = exp(s - lse), delta = rowsum(do * o),
    dp = do v^T, ds = p (dp - delta) scale rounded to the stream dtype, p
    rounded to it before p^T do; the products of stream-dtype values are
    exact in fp32. On a fully masked row lse = -1e30, so p = 1 there."""
    dt = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    do = do.to(dt).float()
    p = torch.exp(_scores(q, k, key_mask) - lse[..., None])
    delta = (do * o.to(dt).float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(q, k, v=None, key_mask=None, query_mask=None):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous 4-D tensor with q's device "
                             f"and dtype, got {tuple(t.shape)} {t.dtype} {t.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"attention kernel takes {DTYPES}, got {q.dtype}")
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != dh or (v is not None and v.shape != k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)}"
                         + ("" if v is None else f" v {tuple(v.shape)}"))
    if dh not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in {HEAD_DIMS}, got {dh}")
    if nq < 1 or nk < 1:
        raise ValueError("attention needs at least one query and one key")
    if any(t.data_ptr() % 16 for t in (q, k, v) if t is not None):
        raise ValueError("attention kernel needs 16-byte aligned q, k, v")
    for name, m, n in (("key_mask", key_mask, nk), ("query_mask", query_mask, nq)):
        if m is not None and (m.shape != (b, n) or m.device != q.device):
            raise ValueError(f"{name}: want [{b}, {n}] on {q.device}, "
                             f"got {tuple(m.shape)} on {m.device}")


def _check_like(name, t, like, dtype=None):
    """t must be a contiguous, 16-byte aligned tensor of like's shape, on its
    device, in `dtype` (like's dtype by default)."""
    dtype = like.dtype if dtype is None else dtype
    if (t.shape != like.shape or t.device != like.device or t.dtype != dtype
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: want a contiguous aligned {tuple(like.shape)} {dtype} tensor "
                         f"on {like.device}, got {tuple(t.shape)} {t.dtype} {t.device}")


def _device_kind(q, what: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {q.device}")
    return q.device.type


def _bool_mask(mask):
    """A mask as the kernels read it, one byte an entry: a contiguous bool
    mask as the caller gave it (no device operation), any other as its
    entries > 0."""
    return None if mask is None else _valid(mask).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def plain_under_autograd(*tensors) -> bool:
    """Whether a CPU call must run the plain version directly: the ops have
    no gradient, and on the CPU the plain version (the ops' CPU body) is
    differentiable, as the wrappers were before they called through the ops."""
    return torch.is_grad_enabled() and any(getattr(t, "requires_grad", False) for t in tensors)


def _forward(q, k, v, key_mask, with_lse: bool):
    """Kernel 1, or kernel 4 with_lse, on CUDA tensors: (out, lse or None)."""
    _check(q, k, v, key_mask)
    b, h, nq, dh = q.shape
    mask = _bool_mask(key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.load("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if with_lse:
            mha_fused_lse.launches += 1
            err = lib.impx_mha_fwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                                       out.data_ptr(), lse.data_ptr(), b * h, h, nq, k.shape[2],
                                       dh, int(q.dtype == torch.bfloat16), stream)
        else:
            mha_fused.launches += 1
            err = lib.impx_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                                   out.data_ptr(), b * h, h, nq, k.shape[2], dh,
                                   int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "impx_mha_fwd_lse" if with_lse else "impx_mha_fwd")
    return out, lse


def _mha_forward(q, k, v, key_mask=None):
    """Kernel 1 without the op's dispatch: the plain version on the CPU, the
    launch on CUDA tensors (the autograd Function's forward)."""
    if _device_kind(q, "attention") == "cpu":
        return mha_reference(q, k, v, key_mask)
    return _forward(q, k, v, key_mask, with_lse=False)[0]


_mha_fwd_op = _ops.define(
    "mha_fwd(Tensor q, Tensor k, Tensor v, Tensor? key_mask) -> Tensor",
    cpu=lambda q, k, v, key_mask: mha_reference(q, k, v, key_mask),
    cuda=lambda q, k, v, key_mask: _forward(q, k, v, key_mask, with_lse=False)[0],
    fake=lambda q, k, v, key_mask: torch.empty_like(q))

_mha_fwd_lse_op = _ops.define(
    "mha_fwd_lse(Tensor q, Tensor k, Tensor v, Tensor? key_mask) -> (Tensor, Tensor)",
    cpu=lambda q, k, v, key_mask: mha_lse_reference(q, k, v, key_mask),
    cuda=lambda q, k, v, key_mask: _forward(q, k, v, key_mask, with_lse=True),
    fake=lambda q, k, v, key_mask: (torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)))


def mha_fused(q, k, v, key_mask=None):
    """Masked attention (kernel 1), through the op `impx::mha_fwd`: CPU
    tensors run `mha_reference`; CUDA tensors launch the kernel in
    impx_torch/csrc/attention.cu or raise. When grad is enabled and q, k or
    v requires it, this is `MhaFunction`, whose backward is `mha_bwd`
    (kernel 3)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return MhaFunction.apply(q, k, v, key_mask, False)
    _device_kind(q, "attention")
    return _mha_fwd_op(q, k, v, key_mask)


mha_fused.launches = 0


def mha_fused_lse(q, k, v, key_mask=None):
    """Kernel 4, through the op `impx::mha_fwd_lse`: (out as `mha_fused`, lse
    [B,H,Nq] fp32). CPU tensors run `mha_lse_reference`; CUDA tensors launch
    impx_torch/csrc/attention.cu or raise. Not differentiable by itself:
    `MhaLseFunction` pairs it with `mha_bwd_from_lse`."""
    if _device_kind(q, "attention") == "cpu" and plain_under_autograd(q, k, v):
        return mha_lse_reference(q, k, v, key_mask)
    return _mha_fwd_lse_op(q, k, v, key_mask)


mha_fused_lse.launches = 0


def _backward(q, k, v, key_mask, do, lse=None, o=None):
    """Kernel 3 (lse is None) or kernel 5 on CUDA tensors: (dq, dk, dv). Two
    launches at either dtype: a dq launch that also writes each query row's
    statistics to `scratch` (kernel 3: the max, base 2 at fp32, 1/sum and
    delta, [3, B*H, Nq]; kernel 5: delta, [B*H, Nq]), then a dk/dv launch
    that reads them."""
    _check(q, k, v, key_mask)
    _check_like("do", do, q)
    b, h, nq, dh = q.shape
    rows = b * h * nq
    if lse is not None:
        _check_like("o", o, q)
        _check_like("lse", lse, q[..., 0], torch.float32)
    mask = _bool_mask(key_mask)
    scratch = torch.empty((rows if lse is not None else 3 * rows,), dtype=torch.float32,
                          device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("attention_bwd")
    sizes = (b * h, h, nq, k.shape[2], dh, int(q.dtype == torch.bfloat16))
    outs = (scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lse is None:
            mha_bwd.launches += 1
            err = lib.impx_mha_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                                   do.data_ptr(), *outs, *sizes, stream)
        else:
            mha_bwd_from_lse.launches += 1
            err = lib.impx_mha_bwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                                       lse.data_ptr(), o.data_ptr(), do.data_ptr(), *outs,
                                       *sizes, stream)
    _build.check(err, "impx_mha_bwd" if lse is None else "impx_mha_bwd_lse")
    return dq, dk, dv


def mha_bwd(q, k, v, key_mask, do):
    """Kernel 3, the VJP of `mha_fused`: (dq, dk, dv) in the inputs' dtype.
    CPU tensors run `mha_bwd_reference`; CUDA tensors launch
    impx_torch/csrc/attention_bwd.cu (two launches, no atomics) or raise."""
    if _device_kind(q, "attention backward") == "cpu":
        return mha_bwd_reference(q, k, v, key_mask, do)
    return _backward(q, k, v, key_mask, do)


mha_bwd.launches = 0


def mha_bwd_from_lse(q, k, v, key_mask, lse, o, do):
    """Kernel 5, the VJP of `mha_fused_lse` from its saved o and lse [B,H,Nq]:
    (dq, dk, dv) in the inputs' dtype. CPU tensors run
    `mha_bwd_from_lse_reference`; CUDA tensors launch
    impx_torch/csrc/attention_bwd.cu (two launches, no atomics) or raise."""
    if _device_kind(q, "attention backward") == "cpu":
        return mha_bwd_from_lse_reference(q, k, v, key_mask, lse, o, do)
    return _backward(q, k, v, key_mask, do, lse=lse, o=o)


mha_bwd_from_lse.launches = 0


class MhaFunction(torch.autograd.Function):
    """Route A's attention core: forward kernel 1, backward kernel 3 from the
    saved q, k, v (impx/ops/pallas/attention.py:_mha, the custom VJP at
    :183-199). plain=True runs their plain versions instead."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, plain: bool):
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, key_mask)
        return (mha_reference if plain else _mha_forward)(q, k, v, key_mask)

    @staticmethod
    def backward(ctx, do):
        with span("impx.attn.backward"):
            q, k, v, key_mask = ctx.saved_tensors
            bwd = mha_bwd_reference if ctx.plain else mha_bwd
            return (*bwd(q, k, v, key_mask, do.contiguous()), None, None)


class MhaLseFunction(torch.autograd.Function):
    """Route B's attention core (impx/models/fast.py:_make_fused_layer): the
    forward kernel 4 saves o and lse, the backward is kernel 5 from them. It
    never falls back to route A. plain=True runs their plain versions
    instead."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, plain: bool):
        ctx.plain = plain
        o, lse = (mha_lse_reference if plain else mha_fused_lse)(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        with span("impx.attn.backward"):
            q, k, v, key_mask, o, lse = ctx.saved_tensors
            bwd = mha_bwd_from_lse_reference if ctx.plain else mha_bwd_from_lse
            return (*bwd(q, k, v, key_mask, lse, o, do.contiguous()), None, None)


# ------------------------------------------------------------ attention key mass
def attention_key_mass_reference(q, k, key_mask=None, query_mask=None):
    """Plain version: per-key attention mass [B, Nk] fp32, the fp32 softmax of
    q k^T / sqrt(dh) over keys (keys valid where key_mask > 0; masked keys at
    the finite -1e30, so a query with no valid key spreads 1/Nk over all Nk
    keys), each query's row weighted by query_mask (0/1), summed over heads
    and queries. None masks mean all ones
    (impx/ops/pallas/attention.py:_mass_kernel :395)."""
    s = _scores(q, k, key_mask)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    if query_mask is None:
        return p.sum(dim=(1, 2))
    return torch.einsum("bhqk,bq->bk", p, query_mask.to(torch.float32))


def attention_key_mass_from_lse_reference(q, k, key_mask, query_mask, lse):
    """Plain version of the mass from each query row's log-sum-exp lse
    [B,H,Nq] fp32 (as `mha_lse_reference` gives it): p = exp(s - lse), 0 at a
    masked key, weighted by query_mask, summed over heads and queries. In a
    batch with no valid key, lse is -1e30 and exp(s - lse) would be 1 a key,
    so that batch takes the reference's uniform 1/Nk instead."""
    p = torch.exp(_scores(q, k, key_mask) - lse[..., None])
    if key_mask is not None:
        none_valid = ~_valid(key_mask).any(dim=1)
        p = torch.where(none_valid[:, None, None, None], 1.0 / k.shape[2], p)
    if query_mask is None:
        return p.sum(dim=(1, 2))
    return torch.einsum("bhqk,bq->bk", p, query_mask.to(torch.float32))


def attention_key_mass(q, k, key_mask=None, query_mask=None, lse=None, splits=None):
    """Per-key attention mass, q [B,H,Nq,dh], k [B,H,Nk,dh], masks [B,Nk] and
    [B,Nq] (0/1) -> [B, Nk] fp32. lse [B,H,Nq] fp32, if given, is each query
    row's log-sum-exp over the same keys and key mask (kernel 4's second
    output). CPU tensors run `attention_key_mass_reference`, or with lse
    `attention_key_mass_from_lse_reference`; CUDA tensors launch
    impx_torch/csrc/attention_mass.cu or raise: the row lse first when lse is
    None, then the mass in one pass. `splits` (for measurement; None takes
    the default, as many CTAs as the card has SMs) divides the (head, query
    tile) items among CTAs, and a second launch sums their partial rows when
    it is above 1. No atomics: the same bits on every run."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention-mass kernel for device {q.device}")
    if q.device.type == "cpu" and plain_under_autograd(q, k, lse):
        return _key_mass_plain(q, k, key_mask, query_mask, lse)
    return _key_mass_op(q, k, key_mask, query_mask, lse, 0 if splits is None else splits)


def _key_mass_plain(q, k, key_mask, query_mask, lse):
    if lse is None:
        return attention_key_mass_reference(q, k, key_mask, query_mask)
    return attention_key_mass_from_lse_reference(q, k, key_mask, query_mask, lse)


def _key_mass_cuda(q, k, key_mask, query_mask, lse, splits):
    """The launches of `attention_key_mass` (splits 0: the default)."""
    _check(q, k, key_mask=key_mask, query_mask=query_mask)
    if lse is not None:
        _check_like("lse", lse, q[..., 0], torch.float32)
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    km, qm = _bool_mask(key_mask), _bool_mask(query_mask)
    lib = _build.load("attention_mass")
    bf16 = int(q.dtype == torch.bfloat16)
    if not splits:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = lib.impx_attention_key_mass_splits(b, h, nq, nk, bf16, sms)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((b, nk), **f32)
    partial = torch.empty((splits, b, nk), **f32) if splits > 1 else None
    sizes = (b * h, h, nq, nk, dh, bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        attention_key_mass.launches += 1
        if lse is None:
            lse = torch.empty((b, h, nq), **f32)
            err = lib.impx_attention_row_lse(q.data_ptr(), k.data_ptr(), _ptr(km), _ptr(qm),
                                             lse.data_ptr(), *sizes, stream)
            _build.check(err, "impx_attention_row_lse")
        err = lib.impx_attention_key_mass(q.data_ptr(), k.data_ptr(), _ptr(km), _ptr(qm),
                                          lse.data_ptr(), _ptr(partial), out.data_ptr(), *sizes,
                                          splits, stream)
    _build.check(err, "impx_attention_key_mass")
    return out


_key_mass_op = _ops.define(
    "attention_key_mass(Tensor q, Tensor k, Tensor? key_mask, Tensor? query_mask, Tensor? lse, int splits) -> Tensor",
    cpu=lambda q, k, key_mask, query_mask, lse, splits: _key_mass_plain(q, k, key_mask, query_mask, lse),
    cuda=_key_mass_cuda,
    fake=lambda q, k, key_mask, query_mask, lse, splits: q.new_empty((q.shape[0], k.shape[2]), dtype=torch.float32))
attention_key_mass.launches = 0
