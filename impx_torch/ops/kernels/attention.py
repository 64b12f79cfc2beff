"""Masked multi-head attention forward and the per-key attention mass of
EIMP pooling: the CUDA kernels' wrappers and their plain PyTorch versions.

Replaces the TPU kernel impx/ops/pallas/attention.py:mha_fused (:203, kernel
`_attn_kernel` :49), which holds all of K and V of one (batch, head) on chip
and needs no online softmax. On the H100, bf16 K and V at N = 2048, dh = 64
take 512 KB, more than one SM's 227 KB of shared memory, so the kernel in
impx_torch/csrc/attention.cu tiles over keys with an online softmax.

What bounds it on the H100: the QK^T and P.V products (4 * N^2 * dh flops per
(batch, head)), against 989 TFLOP/s of bf16 tensor cores; the exponentials
take about as long on the special-function units, and q, k, v, o move a
third of that time's bytes. The design keeps scores and probabilities in
registers (never in device memory): one block per (batch*head, 64 queries),
64-key tiles of K and V staged in shared memory, bf16 mma.sync (m16n8k16)
with fp32 accumulation; fp32 inputs take an FMA path that keeps full fp32.

Semantics, as the TPU kernel: scores scaled by 1/sqrt(dh) before masking;
invalid keys get the finite -1e30 (a fully masked row gives uniform weights,
never NaN); fp32 softmax; P cast to the input dtype for P.V with fp32
accumulation; the division by the row sum comes after P.V.

`attention_key_mass` replaces impx/ops/pallas/attention.py:attention_key_mass
(:422, kernel `_mass_kernel` :395), which carries one [Nk] sum across a
sequential (head, query-block) grid. Blocks on the H100 run in parallel and
carry nothing, so impx_torch/csrc/attention_mass.cu writes one partial row
per (head, 64-query tile) and a second launch sums them in a fixed order.
"""
from __future__ import annotations

import torch

from impx_torch.ops.kernels import _build

NEG = -1e30
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64)


def mha_reference(q, k, v, key_mask=None):
    """Plain version: q [B,H,Nq,dh], k/v [B,H,Nk,dh], key_mask [B,Nk] ->
    [B,H,Nq,dh] in q's dtype. Products of bf16 inputs are exact in fp32, so
    upcasting before the matmul is the TPU kernel's fp32 accumulation."""
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / dh ** 0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :].bool(), s, NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


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


def mha_fused(q, k, v, key_mask=None):
    """Masked attention. CPU tensors run `mha_reference`; CUDA tensors launch
    the kernel in impx_torch/csrc/attention.cu or raise."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check(q, k, v, key_mask)
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    mask = None if key_mask is None else key_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        mha_fused.launches += 1
        err = lib.impx_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               None if mask is None else mask.data_ptr(),
                               out.data_ptr(), b * h, h, nq, nk, dh,
                               int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "impx_mha_fwd")
    return out


mha_fused.launches = 0


# ------------------------------------------------------------ attention key mass
def attention_key_mass_reference(q, k, key_mask=None, query_mask=None):
    """Plain version: per-key attention mass [B, Nk] fp32, the fp32 softmax of
    q k^T / sqrt(dh) over keys (masked keys at the finite -1e30, so a query
    with no valid key spreads 1/Nk over all Nk keys), each query's row
    weighted by query_mask (0/1), summed over heads and queries. None masks
    mean all ones (impx/ops/pallas/attention.py:_mass_kernel :395)."""
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / dh ** 0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :].bool(), s, NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    if query_mask is None:
        return p.sum(dim=(1, 2))
    return torch.einsum("bhqk,bq->bk", p, query_mask.to(torch.float32))


def attention_key_mass(q, k, key_mask=None, query_mask=None):
    """Per-key attention mass, q [B,H,Nq,dh], k [B,H,Nk,dh], masks [B,Nk] and
    [B,Nq] -> [B, Nk] fp32. CPU tensors run `attention_key_mass_reference`;
    CUDA tensors launch the kernels in impx_torch/csrc/attention_mass.cu (a
    pass per 64-query tile into partial sums, then a fixed-order sum: no
    atomics, the same bits on every run) or raise."""
    if q.device.type == "cpu":
        return attention_key_mass_reference(q, k, key_mask, query_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no attention-mass kernel for device {q.device}")
    _check(q, k, key_mask=key_mask, query_mask=query_mask)
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    km = None if key_mask is None else key_mask.to(torch.float32).contiguous()
    qm = None if query_mask is None else query_mask.to(torch.float32).contiguous()
    lib = _build.load("attention_mass")
    f32 = dict(dtype=torch.float32, device=q.device)
    partial = torch.empty((b, h * -(-nq // lib.impx_attention_key_mass_block_q()), nk), **f32)
    out = torch.empty((b, nk), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        attention_key_mass.launches += 1
        err = lib.impx_attention_key_mass(
            q.data_ptr(), k.data_ptr(), None if km is None else km.data_ptr(),
            None if qm is None else qm.data_ptr(), partial.data_ptr(), out.data_ptr(),
            b * h, h, nq, nk, dh, int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "impx_attention_key_mass")
    return out


attention_key_mass.launches = 0
