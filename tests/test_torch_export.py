"""The serving export of the port (impx_torch/tools/export.py) through
torch.export, mirroring impx's three cases (tests/test_export.py): the round
trip through bytes against the eager port (indices0 bit-equal) and impx's
produce_matches (indices0 on every row, mscores0 within the matcher tests'
fp32 tolerance, 1e-5); weights as a runtime argument serving a second
checkpoint; an artifact exported on the CPU and moved to another device on
load. The exported graph names the kernel ops (impx::mha_fwd and
impx::sinkhorn_stats for DGNNS; kernels 4 and 6 too for EIMP), not their
plain bodies. Small config: D = 32, 3 layers (4 for EIMP), N = 48, B = 2.
"""
import collections
import io

import numpy as np
import pytest

import jax

from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig

import torch

from impx_torch.models import AdaGMN, DGNNS, MatcherConfig, SuperGlue
from impx_torch.tools.convert import params_from_jax
from impx_torch.tools.export import export_matcher, load_matcher

SMALL = dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=3, sinkhorn_iterations=10, norm_fn="in")
N, B = 48, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the small eager calls beside a tier-1 run's other
    workers cost more across threads than on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feed(seed=7):
    """Image 1 a permutation of image 0 with small descriptor noise (so that a
    share of the keypoints match at random weights), the last keypoints of
    each pair padding."""
    rs = np.random.RandomState(seed)
    d0 = rs.randn(B, N, 32).astype(np.float32)
    k0 = (0.5 * rs.randn(B, N, 2)).astype(np.float32)
    s0 = rs.rand(B, N).astype(np.float32)
    v0 = np.arange(N)[None] < np.array([N - 7, N - 2])[:, None]
    perm = np.stack([rs.permutation(N) for _ in range(B)])
    take = lambda x: np.take_along_axis(x, perm.reshape(perm.shape + (1,) * (x.ndim - 2)), axis=1)
    return {"descriptors0": d0, "descriptors1": take(d0) + 0.01 * rs.randn(B, N, 32).astype(np.float32),
            "norm_keypoints0": k0, "norm_keypoints1": take(k0), "scores0": s0, "scores1": take(s0),
            "valid0": v0, "valid1": take(v0)}


def _pair(seed):
    jmodel = JaxDGNNS(JaxConfig(**SMALL, attn_impl="xla"))
    params = jmodel.init(jax.random.PRNGKey(seed))
    cfg = MatcherConfig(**SMALL)
    model = DGNNS(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.array, params), cfg))
    return jmodel, params, model


def _impx(jmodel, params, feed):
    out = jax.jit(lambda prm, f: jmodel.produce_matches(prm, f, p=0.2, only_last=True, with_scores=False))(
        params, feed)
    return np.asarray(out["indices0"][-1]), np.asarray(out["mscores0"][-1])


def _torch(feed):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in feed.items()}


def _eager(model, feed):
    out = model.produce_matches(feed, p=0.2, only_last=True, with_scores=False)
    return out["indices0"][-1], out["mscores0"][-1]


@pytest.fixture(scope="module")
def exported():
    jmodel, params, model = _pair(0)
    return jmodel, params, model, export_matcher(model, n_kpts=N, batch=B)


def test_export_roundtrip_matches(exported):
    jmodel, params, model, blob = exported
    assert isinstance(blob, bytes) and len(blob) > 0
    feed = _feed()
    out = load_matcher(blob)(_torch(feed))
    idx, ms = _eager(model, _torch(feed))
    assert torch.equal(out["indices0"], idx) and torch.equal(out["mscores0"], ms)
    ref_idx, ref_ms = _impx(jmodel, params, feed)
    assert (ref_idx >= 0).sum() > 10   # real matches, not all -1
    np.testing.assert_array_equal(out["indices0"].numpy(), ref_idx)
    np.testing.assert_allclose(out["mscores0"].numpy(), ref_ms, rtol=0, atol=1e-5)


def test_export_runtime_params():
    """bake_params=False: the weights are a runtime argument, one artifact
    for many checkpoints; a second set of weights is served as the eager
    port and impx serve it."""
    _, _, model = _pair(0)
    blob = export_matcher(model, n_kpts=N, batch=B, bake_params=False)
    program = torch.export.load(io.BytesIO(blob))
    assert not program.state_dict and not program.constants   # no weight in the artifact
    jmodel2, params2, model2 = _pair(3)
    feed = _feed()
    out = load_matcher(blob)(_torch(feed), model2.state_dict())
    idx, _ = _eager(model2, _torch(feed))
    assert torch.equal(out["indices0"], idx)
    np.testing.assert_array_equal(out["indices0"].numpy(), _impx(jmodel2, params2, feed)[0])


def test_export_moved_to_another_device(exported):
    """impx's multi-platform artifact: here one exported on the CPU and moved
    on load (torch.export.passes.move_to_device_pass). On the meta device
    every op runs its shape function: the outputs have the served shapes
    there (on the card, chip_smoke.py phase 24 moves it to cuda)."""
    *_, blob = exported
    out = load_matcher(blob, device="meta")({k: v.to("meta") for k, v in _torch(_feed()).items()})
    assert out["indices0"].device.type == "meta" and out["indices0"].shape == (B, N)
    assert out["mscores0"].dtype == torch.float32 and out["mscores0"].shape == (B, N)


def _op_counts(blob) -> collections.Counter:
    program = torch.export.load(io.BytesIO(blob))
    return collections.Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")


def test_exported_graph_names_the_kernel_ops(exported):
    """DGNNS: one impx::mha_fwd a layer (kernel 1) and one
    impx::sinkhorn_stats (kernel 2), none of the plain bodies' exponentials
    or softmaxes."""
    *_, blob = exported
    ops = _op_counts(blob)
    assert ops["impx.mha_fwd.default"] == 2 * SMALL["n_layers"]
    assert ops["impx.sinkhorn_stats.default"] == 1
    assert not [k for k in ops if "exp" in k or "softmax" in k or "logsumexp" in k], ops


def test_export_eimp_mask_only():
    """AdaGMN mask-only: the round trip equals the eager port bit for bit,
    and the graph holds kernel 4 (the pooling iterations' layers), kernel 6
    (two mass calls a pool) and kernel 2 (a head an iteration)."""
    cfg = MatcherConfig(**{**SMALL, "n_layers": 4}, n_min_tokens=8, first_it_to_update=1)
    model = AdaGMN(cfg, device="cpu", seed=4)
    model.bin_score.data.fill_(5.0)     # pooling drops keypoints at random weights
    blob = export_matcher(model, n_kpts=N, batch=B)
    feed = _torch(_feed(11))
    out = load_matcher(blob)(feed)
    eager = model.produce_matches(feed, p=0.2, only_last=True, with_scores=False)
    assert torch.equal(out["indices0"], eager["indices0"][-1])
    assert torch.equal(out["mscores0"], eager["mscores0"][-1])
    assert (~eager["keep0"]).any()
    pools = sum(1 for i in range(cfg.n_layers) if cfg.sharing_layers(True)[2 * i] and i >= 1)
    ops = _op_counts(blob)
    assert ops["impx.attention_key_mass.default"] == 2 * pools
    assert ops["impx.mha_fwd_lse.default"] == 2 * pools
    assert ops["impx.mha_fwd.default"] == 2 * (cfg.n_layers - pools)
    assert ops["impx.sinkhorn_stats.default"] == cfg.n_layers


def test_export_superglue_holds_the_log_sinkhorn_op():
    """SuperGlue (the log-OT head, batch norm from running statistics):
    kernel 7's op impx::log_sinkhorn_stats in the graph, the round trip
    equal to the eager port."""
    model = SuperGlue(MatcherConfig(**{**SMALL, "n_layers": 2}, log_ot=True), device="cpu", seed=2)
    blob = export_matcher(model, n_kpts=N, batch=B)
    feed = _torch(_feed())
    assert torch.equal(load_matcher(blob)(feed)["indices0"], _eager(model, feed)[0])
    ops = _op_counts(blob)
    assert ops["impx.log_sinkhorn_stats.default"] == 1 and ops["impx.mha_fwd.default"] == 4


@pytest.mark.cuda
def test_cpu_export_served_on_the_card_launches_the_kernels():
    """An artifact exported on the CPU, moved to cuda on load: it launches
    kernel 1 once a layer and kernel 2 once, and gives the eager card
    path's indices0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from impx_torch.ops.kernels.attention import mha_fused
    from impx_torch.ops.kernels.sinkhorn import sinkhorn_fused_stats

    _, _, model = _pair(0)
    blob = export_matcher(model, n_kpts=N, batch=B)
    feed = {k: v.cuda() for k, v in _torch(_feed()).items()}
    fn = load_matcher(blob, device="cuda")
    mha_fused.launches = sinkhorn_fused_stats.launches = 0
    out = fn(feed)
    assert (mha_fused.launches, sinkhorn_fused_stats.launches) == (2 * SMALL["n_layers"], 1)
    card = DGNNS(MatcherConfig(**SMALL), device="cuda")
    card.load_state_dict(model.state_dict())
    idx, _ = _eager(card, feed)
    assert torch.equal(out["indices0"], idx)
