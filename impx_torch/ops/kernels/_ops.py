"""The `impx` operator library: each inference kernel as a torch.library op
with a CPU implementation (its plain version), a CUDA one (the launch) and a
fake one (the output shapes, for torch.export), so that an exported program
holds the kernels. Registered through torch.library.Library: its dispatch
costs a few microseconds of host time a call, where torch.library.custom_op's
Python wrappers cost several times more."""
from __future__ import annotations

import torch

LIB = torch.library.Library("impx", "DEF")


def define(schema: str, cpu, cuda, fake):
    """Define `impx::<schema>` with its three implementations; returns the op
    (its default overload)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"impx::{name}", fake, lib=LIB)
    return getattr(torch.ops.impx, name).default
