"""The MLP block's epilogue, y = act(InstanceNorm_mask(p + b)): the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces no TPU kernel. The JAX package leaves the bias add, the masked
InstanceNorm and the activation after each dense block but the last
(impx/ops/mlp.py:71) to XLA, which fuses them; in PyTorch's eager mode the
same chain (`norms.instance_norm` between the bias add and `activation`) is
19 device launches on an H100, ten of which read and write the whole [R, N, C]
tensor: 0.29 ms at [8, 2000, 512] fp32, where the kernel takes 0.043.

What bounds it on the H100: bytes, the product read once and y written once.
impx_torch/csrc/norm.cu reads the product from device memory once: a
thread-block cluster of CLUSTER CTAs (the size is passed to the launch) for
each (image, slice of channels), each CTA holding its share of the image's
rows in shared memory; the partial moments meet through distributed shared
memory in a fixed order, and every CTA normalises, activates and stores its
rows from shared memory. Where a CTA's rows do not fit its shared memory
(some 51,200 tokens at 512 fp32 channels), the kernel reads them from device
memory in each of its passes: any token count runs.

Numerics, as the plain path: the bias added in the product's dtype, fp32
statistics over the valid tokens (count clamped at 1), the centred variance,
eps 1e-3, padded rows normalised with the valid rows' statistics; under bf16
y is rounded to bf16 before the activation. Sums run in another order than
PyTorch's, so on the card the kernel agrees with the plain path to fp32
rounding, and gives the same bits on every call.

The kernel is the `torch.library` op `impx::norm_act` (CUDA: the launch;
CPU: the plain version, bit for bit the chain it replaces; a fake
implementation for the shape), so an exported matcher keeps it. It has no
gradient: `mlp_apply` takes it only where autograd is off for the block.
"""
from __future__ import annotations

import torch

from impx_torch.ops import norms
from impx_torch.ops.kernels import _build, _ops

ACTIVATIONS = {"relu": 0, "gelu": 1, "lrelu": 2}
CLUSTER = 8                    # CTAs a cluster, each a share of an image's rows (norm.cu takes 1 to 8)
SLICES = (64, 32, 16, 8)       # channels a cluster, as norm.cu instantiates them (8: tensor parallelism
                               # over 4 ranks leaves the encoder's first block 32 / 4 channels)
TILE_TARGET = 32 * 1024        # a CTA's rows of its slice: the widest slice within this, else the narrowest


def norm_act_reference(x, bias, mask, ac_fn: str):
    """Plain version: act(instance_norm((x + bias) in fp32) in x's dtype),
    mlp_apply's chain after the product. x [R, N, C], bias [C] in x's dtype,
    mask [R, N] or None."""
    from impx_torch.ops.mlp import activation

    s = x + bias
    return activation(norms.instance_norm(s.float(), mask=mask).to(s.dtype), ac_fn)


def slice_for(n: int, c: int, itemsize: int) -> int | None:
    """The channels a cluster takes at n tokens and c channels: the widest
    slice dividing c whose rows a CTA holds within TILE_TARGET bytes, else
    the narrowest dividing c; None when none divides c."""
    rows = -(-n // CLUSTER)
    fits = [s for s in SLICES if c % s == 0]
    if not fits:
        return None
    return next((s for s in fits if rows * s * itemsize <= TILE_TARGET), fits[-1])


def kernel_takes(x, mask) -> bool:
    """Whether the kernel takes x [R, N, C] and mask: fp32 or bf16, C a
    multiple of 8, a bool mask or none."""
    return (x.dim() == 3 and x.dtype in (torch.float32, torch.bfloat16)
            and (mask is None or mask.dtype == torch.bool)
            and slice_for(x.shape[1], x.shape[2], x.element_size()) is not None)


def norm_act(x, bias, mask, ac_fn: str):
    """act(InstanceNorm_mask(x + bias)) through the op `impx::norm_act`: CPU
    tensors run `norm_act_reference`; CUDA tensors launch the kernel in
    impx_torch/csrc/norm.cu, or raise ValueError for what it does not take
    (`kernel_takes`). No gradient."""
    return _norm_act_op(x, bias, mask, ac_fn)


def _cuda(x, bias, mask, ac_fn):
    r, n, c = x.shape if x.dim() == 3 else (0, 0, 0)
    if not kernel_takes(x, mask) or ac_fn not in ACTIVATIONS:
        raise ValueError(f"norm_act kernel: no launch for {tuple(x.shape)} {x.dtype}, mask "
                         f"{None if mask is None else mask.dtype}, activation {ac_fn!r}")
    if x.numel() == 0:
        return torch.empty_like(x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    if bias.shape != (c,) or bias.dtype != x.dtype or bias.device != x.device:
        raise ValueError(f"bias: want [{c}] {x.dtype} on {x.device}, got {tuple(bias.shape)} {bias.dtype}")
    if not bias.is_contiguous() or bias.data_ptr() % 16:
        bias = bias.clone(memory_format=torch.contiguous_format)
    if mask is not None:
        if mask.shape != (r, n) or mask.device != x.device:
            raise ValueError(f"mask: want [{r}, {n}] on {x.device}, got {tuple(mask.shape)}")
        mask = mask.contiguous()
    out = torch.empty_like(x)
    lib = _build.load("norm")
    with torch.cuda.device(x.device):
        norm_act.launches += 1
        err = lib.impx_norm_act(x.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
                                out.data_ptr(), r, n, c, slice_for(n, c, x.element_size()), CLUSTER,
                                ACTIVATIONS[ac_fn], int(x.dtype == torch.bfloat16),
                                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "impx_norm_act")
    return out


norm_act.launches = 0

_norm_act_op = _ops.define(
    "norm_act(Tensor x, Tensor bias, Tensor? mask, str ac_fn) -> Tensor",
    cpu=norm_act_reference, cuda=_cuda,
    fake=lambda x, bias, mask, ac_fn: torch.empty_like(x))
