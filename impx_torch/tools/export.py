"""Serialized matcher export for serving (impx/tools/export.py), through
`torch.export`.

`export_matcher` traces the flagship forward (`produce_matches(only_last=
True, with_scores=False)`) at a fixed keypoint bucket into an
ExportedProgram and returns its bytes (`torch.export.save` through a
buffer). The kernels are `torch.library` ops (impx::mha_fwd,
impx::sinkhorn_stats, ...; impx_torch/ops/kernels), so the graph names them:
the loaded program launches the same CUDA kernels as an eager call on the
card, and runs their plain versions on the CPU. Weights are baked into the
artifact by default, or kept as a runtime argument (`bake_params=False`,
through `torch.func.functional_call`), so that one artifact serves many
checkpoints.

impx's multi-platform artifact (platforms=("cpu", "tpu")) maps to one
device's export moved to another on load (`load_matcher(blob, device=)`,
`torch.export.passes.move_to_device_pass`).

Usage:
    blob = export_matcher(model, n_kpts=2048)
    Path("imp_2048.pt2").write_bytes(blob)
    ...
    fn = load_matcher(Path("imp_2048.pt2").read_bytes(), device="cuda")
    out = fn(feed)           # dict with indices0 / mscores0
"""
from __future__ import annotations

import io
from typing import Any, Callable

import torch
from torch import nn


def _example_feed(n_kpts: int, dim: int, batch: int, device=None) -> dict[str, Any]:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "descriptors0": torch.zeros((batch, n_kpts, dim), **f32),
        "descriptors1": torch.zeros((batch, n_kpts, dim), **f32),
        "norm_keypoints0": torch.zeros((batch, n_kpts, 2), **f32),
        "norm_keypoints1": torch.zeros((batch, n_kpts, 2), **f32),
        "scores0": torch.zeros((batch, n_kpts), **f32),
        "scores1": torch.zeros((batch, n_kpts), **f32),
        "valid0": torch.zeros((batch, n_kpts), dtype=torch.bool, device=device),
        "valid1": torch.zeros((batch, n_kpts), dtype=torch.bool, device=device),
    }


class _Serve(nn.Module):
    """feed dict [, params] -> {indices0, mscores0} of the last iteration.
    Without baked weights the model is held outside the module tree, so its
    own parameters are not traced into the program: functional_call puts
    the params argument in their place."""

    def __init__(self, model, p: float, bake_params: bool):
        super().__init__()
        self.p, self.bake_params = p, bake_params
        if bake_params:
            self.model = model
        else:
            object.__setattr__(self, "unbaked", _ProduceMatches(model, p))

    def forward(self, feed, params=None):
        if self.bake_params:
            out = self.model.produce_matches(feed, p=self.p, only_last=True, with_scores=False)
        else:
            out = torch.func.functional_call(self.unbaked, {f"model.{k}": v for k, v in params.items()}, (feed,))
        return {"indices0": out["indices0"][-1], "mscores0": out["mscores0"][-1]}


class _ProduceMatches(nn.Module):
    """The model's produce_matches as its forward, for functional_call."""

    def __init__(self, model, p: float):
        super().__init__()
        self.model, self.p = model, p

    def forward(self, feed):
        return self.model.produce_matches(feed, p=self.p, only_last=True, with_scores=False)


def matcher_serving_fn(model, *, p: float = 0.2, bake_params: bool = True) -> Callable:
    """The serving entry as a module: feed dict -> {indices0, mscores0}; with
    bake_params=False it takes (feed, params), params keyed as the model's
    state_dict."""
    return _Serve(model, p, bake_params)


def export_matcher(model, *, n_kpts: int = 2048, batch: int = 1, p: float = 0.2, bake_params: bool = True,
                   device=None) -> bytes:
    """Serialize the matcher's forward at a fixed bucket to the bytes of a
    torch.export program. device: where the example feed lives, the model's
    device by default (the traced program is specialised to it; move it on
    load)."""
    device = model.device if device is None else torch.device(device)
    serve = matcher_serving_fn(model, p=p, bake_params=bake_params)
    args = (_example_feed(n_kpts, model.config.descriptor_dim, batch, device),)
    if not bake_params:
        args += ({k: v.detach() for k, v in model.state_dict().items()},)
    with torch.no_grad():
        program = torch.export.export(serve, args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_matcher(blob: bytes, device=None) -> Callable:
    """Deserialize an exported matcher; returns fn(feed[, params]) -> dict.
    Needs torch and impx_torch.ops.kernels (imported here), which registers
    the kernel ops the graph calls; not the model code. device: move the
    program there (an artifact exported on the CPU served on the card, or
    the reverse)."""
    import impx_torch.ops.kernels  # noqa: F401  (registers the impx:: ops)

    program = torch.export.load(io.BytesIO(blob))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    module = program.module()

    def serve(feed, params=None):
        with torch.no_grad():
            return module(dict(feed)) if params is None else module(dict(feed), dict(params))

    return serve
