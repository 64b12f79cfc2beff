"""impx_torch — the IMP matcher in PyTorch, with hand-written CUDA kernels for Hopper.

A port of `impx` (JAX/Pallas) that mirrors its module layout:

  models/   config, gnn, gm, dgnns, adgm, superglue, fast, loss (the matchers
            as nn.Modules, their forwards and the training loss)
  ops/      norms, mlp, attention, sinkhorn, matching (plain tensor functions)
  ops/kernels/  the CUDA kernels' wrappers, each beside its plain version
  geometry/ keypoints
  train/    step (Adam, LR schedule, NaN guard), trainer
  tools/    convert (weights from the JAX pytree or the reference state_dict)
  csrc/     the CUDA C++ sources, built at first use by ops/kernels/_build.py

The package imports torch and never jax. Entry points run on the CUDA device
unless the caller passes device="cpu"; on CPU tensors every kernel wrapper
runs its plain PyTorch version.
"""
from impx_torch.device import resolve_device

__all__ = ["resolve_device"]
