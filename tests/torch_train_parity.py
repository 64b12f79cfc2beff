"""Shared setup of the training parity tests (not a test file): impx's model
and params beside the port's with the same weights, and the check of a
forward_train (loss, its terms, matches0, accuracy, every gradient leaf)
against impx's under jax.jit.
"""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.models import MatcherConfig as JaxConfig

from impx_torch.models import MatcherConfig
from impx_torch.tools.convert import params_from_jax

D = 32
SMALL = dict(descriptor_dim=D, keypoint_encoder=(16, 32), num_heads=4, sinkhorn_iterations=10)
# fp32: loss, its terms and the accuracy counters rtol 1e-5, matches0 and
# keep masks exact, every gradient leaf rtol 2e-3 atol 1e-5 (the bounds of
# tests/test_torch_train.py), the leaves whose exact gradient is 0 within
# 1e-5 of the largest leaf's norm
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, ZERO_REL = 1e-5, 2e-3, 1e-5, 1e-5


def pair(jax_cls, torch_cls, jax_extra=None, seed=1, bin_score=None, **fields):
    """impx's model (with jax_extra, e.g. attn_impl) and its params from
    PRNGKey(seed), and the port's model with the same weights, both at
    SMALL plus `fields`; bin_score, when given, replaces the dustbin score
    in both (a larger one lets pooling drop keypoints at random weights)."""
    jmodel = jax_cls(JaxConfig(**SMALL, **fields, **(jax_extra or {})))
    params = jmodel.init(jax.random.PRNGKey(seed))
    if bin_score is not None:
        params = {**params, "bin_score": jnp.asarray(bin_score, jnp.float32)}
    tcfg = MatcherConfig(**SMALL, **fields)
    tmodel = torch_cls(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tcfg, tmodel.sharing))
    return jmodel, params, tmodel, tcfg


def jax_train(jmodel, params, data):
    """((loss, impx's forward_train dict), gradients) under jax.jit."""
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    step = jax.jit(jax.value_and_grad(lambda p, d: (lambda o: (o["loss"], o))(jmodel.forward_train(p, d)),
                                      has_aux=True))
    return step(params, jdata)


def torch_grads(tmodel) -> dict:
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy() for n, p in tmodel.named_parameters()}


def check_train(jmodel, params, tmodel, tcfg, data, zero: re.Pattern, accuracy_abs: float = 1e-6):
    """The port's forward_train and its gradients against impx's at the
    tolerances above. zero: the leaves whose exact gradient is 0. Returns
    the port's output and impx's."""
    (loss, ref), jgrads = jax_train(jmodel, params, data)
    tmodel.zero_grad(set_to_none=True)
    out = tmodel.forward_train(data)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=LOSS_RTOL)
    for key in ("matching_loss", "matching_loss_corr", "matching_loss_incorr", "matching_loss_neg", "geo_loss"):
        np.testing.assert_allclose(out[key].item(), float(ref[key]), rtol=LOSS_RTOL, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out["matches0"].numpy(), np.asarray(ref["matches0"]))
    for key in ("acc_corr", "acc_incorr", "total_acc_corr", "total_acc_incorr"):
        assert float(out[key]) == pytest.approx(float(ref[key]), rel=LOSS_RTOL, abs=accuracy_abs), key
    want = params_from_jax(jax.tree.map(np.array, jgrads), tcfg, tmodel.sharing)
    got = torch_grads(tmodel)
    assert got.keys() == want.keys()
    biggest = max(np.linalg.norm(g.numpy()) for g in want.values())
    assert np.abs(got["bin_score"]).max() > 0
    for name, g in got.items():
        if zero.search(name):
            assert np.linalg.norm(g - want[name].numpy()) <= ZERO_REL * biggest, name
        else:
            np.testing.assert_allclose(g, want[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    return out, ref


def in_zero_grad_leaves(model) -> re.Pattern:
    """Leaves whose exact gradient is 0 when every MLP normalises each
    channel over its tokens (masked InstanceNorm, or batch norm from batch
    statistics): a bias that shifts every token of a channel alike before
    such a norm, and k's bias (a constant per softmax row)."""
    last = len(model.kenc.blocks) - 1
    return re.compile(rf"(kenc\.blocks\.[0-{last - 1}]\.bias|attn\.[kv]\.bias|merge\.bias|proj\.bias"
                      r"|mlp\.blocks\.0\.bias)$")


def bn_layers_zero_grad_leaves(model) -> re.Pattern:
    """The same when only the keypoint encoder normalises from batch
    statistics and the layers from running statistics (a per-channel
    affine map, which keeps a shift): the encoder's biases before its norms
    and k's bias."""
    last = len(model.kenc.blocks) - 1
    return re.compile(rf"(kenc\.blocks\.[0-{last - 1}]\.bias|attn\.k\.bias)$")
