"""EIMP training (AdaGMN.forward_train) against impx's on the CPU: the masked
training scan, the compacted one, the unrolled loop under batch norm and at
N0 != N1, the restricted ground truth, and the log-OT departure.

Small config: D = 32, keypoint_encoder (16, 32), 4 heads, 6 layers on the
scans (pooling at iterations 3 and 5: first_it_to_update 2, n_min_tokens 8)
and 4 on the unrolled loop (one pool, at iteration 3: impx compiles its loop
a layer at a time), 10 Sinkhorn iterations, B = 2, N = 48 with 7 and 2 padded keypoints, a dustbin score of
5 so that pooling drops keypoints at random weights. impx runs under
jax.jit: its scans on attn_impl='pallas' (kernels interpreted,
train_remat='none' so that each pool records its keep masks once), its
unrolled loop on attn_impl='xla'. Torch runs on one thread.

Tolerances, fp32: loss, its terms and the accuracy counters rtol 1e-5;
matches0 and the keep masks of every pool exact; each gradient leaf rtol
2e-3 atol 1e-5, the leaves whose exact gradient is 0 within 1e-5 of the
largest leaf's norm (tests/torch_train_parity.py).
"""
import numpy as np
import pytest

import jax
import torch

from impx.models import AdaGMN as JaxAdaGMN
from impx.models import DGNNS as JaxDGNNS
from impx.models.adgm import _masked_gt as jax_masked_gt
from impx.models.fast import _gather_gt as jax_gather_gt

from impx_torch.models import AdaGMN, MatcherConfig
from impx_torch.models.adgm import _masked_gt
from impx_torch.models.fast import _gather_gt

from test_torch_train import train_batch
from torch_train_parity import (
    SMALL, check_train, in_zero_grad_leaves, jax_train, pair, torch_grads)

EIMP = dict(n_layers=6, norm_fn="in", first_it_to_update=2, n_min_tokens=8)
LOOP = dict(EIMP, n_layers=4)
BIN_SCORE = 5.0
SCAN = dict(attn_impl="pallas", train_remat="none")
XLA = dict(attn_impl="xla")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def batch():
    return train_batch(np.random.RandomState(0))


def cut_image1(data, m):
    """Image 1 cut to its first m keypoints: image-0 rows matched beyond m
    go to the dustbin column."""
    out = {k: (v[:, :m] if k in ("descriptors1", "norm_keypoints1", "scores1", "valid1") else v)
           for k, v in data.items()}
    gt = data["matching_mask"]
    n1 = gt.shape[2] - 1
    cut = np.concatenate([gt[:, :, :m], gt[:, :, n1:]], axis=2)
    cut[:, :-1, m] = np.minimum(cut[:, :-1, m] + gt[:, :-1, m:n1].sum(2), 1.0)
    out["matching_mask"] = cut
    return out


class RecordingAdaGMN(JaxAdaGMN):
    """impx's AdaGMN recording the keep masks of each pool."""

    def _pool_from_masses(self, *args):
        keep0, keep1 = super()._pool_from_masses(*args)
        jax.debug.callback(lambda a, b: self.keeps.append((np.asarray(a), np.asarray(b))), keep0, keep1)
        return keep0, keep1


def recording(tmodel):
    """Record the port's keep masks of each pool."""
    tmodel.keeps = []
    pool = tmodel._pool_from_masses

    def recorded(*args):
        keep0, keep1 = pool(*args)
        tmodel.keeps.append((keep0.numpy().copy(), keep1.numpy().copy()))
        return keep0, keep1

    tmodel._pool_from_masses = recorded
    return tmodel


def check_eimp(data, jax_extra, n_pools=2, **fields):
    """check_train on AdaGMN plus the keep masks of every pool, which must
    drop keypoints. Returns the port's output and impx's."""
    jmodel, params, tmodel, tcfg = pair(RecordingAdaGMN, AdaGMN, jax_extra, bin_score=BIN_SCORE,
                                        **{**EIMP, **fields})
    jmodel.keeps = []
    out, ref = check_train(jmodel, params, recording(tmodel), tcfg, data, in_zero_grad_leaves(tmodel))
    assert len(tmodel.keeps) == len(jmodel.keeps) == n_pools
    for (a0, a1), (r0, r1) in zip(tmodel.keeps, jmodel.keeps):
        np.testing.assert_array_equal(a0, r0)
        np.testing.assert_array_equal(a1, r1)
    final = tmodel.keeps[-1]
    assert final[0].sum() < data["valid0"].sum() and final[1].sum() < data["valid1"].sum()
    return out, ref


# ------------------------------------------------------------------ pieces
def test_masked_gt_and_gather_gt_match_impx(batch):
    rs = np.random.RandomState(3)
    gt = batch["matching_mask"]
    keep0, keep1 = batch["valid0"] & (rs.rand(2, 48) < 0.7), batch["valid1"] & (rs.rand(2, 48) < 0.6)
    out = _masked_gt(torch.from_numpy(gt), torch.from_numpy(keep0), torch.from_numpy(keep1))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_masked_gt(gt, keep0, keep1)))
    i0 = np.stack([rs.permutation(48)[:20] for _ in range(2)]).astype(np.int32)
    i1 = np.stack([rs.permutation(48)[:20] for _ in range(2)]).astype(np.int32)
    out = _gather_gt(torch.from_numpy(gt), torch.from_numpy(i0).long(), torch.from_numpy(i1).long())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_gather_gt(gt, i0, i1)))


# ------------------------------------------------------------------ the scans
def test_masked_training_scan_matches_impx(batch):
    """The masked training scan (fast.py:forward_train_scan_eimp) against
    impx's forward_train_scan_eimp: loss, terms, accuracy averaged over all
    iterations, matches0, both pools' keep masks, every gradient leaf."""
    check_eimp(batch, SCAN)


def test_compacted_training_scan_matches_impx(batch):
    """A shrinking schedule, (2, 44) before the first pool (pair 1's 46
    valid keypoints overflow by 2 in each image) and (4, 24) after it, both
    on iterations whose layers do not share attention, so impx's gather of
    the cross k (ROADMAP section C) is not read: against impx's
    forward_train_scan_eimp_compact, with the overflow counters."""
    assert not any(MatcherConfig(**SMALL, **EIMP).sharing_layers(True)[2 * it] for it in (2, 4))
    out, ref = check_eimp(batch, SCAN, train_compaction=((2, 44), (4, 24)))
    for key in ("compaction_overflow0", "compaction_overflow1"):
        assert float(out[key]) == float(ref[key]), key
    assert float(out["compaction_overflow0"]) > 2 and float(out["compaction_overflow1"]) > 2


def test_compaction_identity_is_exact(batch):
    """A bucket of n before any pool is a reordering: the compacted trainer
    equals the masked one, loss, metrics and every gradient, as impx's
    tests/test_fast_train.py:test_eimp_train_compaction_identity_exact holds
    its own (loss rtol 1e-6, gradients rtol 1e-5 atol 1e-7)."""
    outs = []
    for schedule in ((), ((1, 48),)):
        model = AdaGMN(MatcherConfig(**SMALL, **EIMP, train_compaction=schedule), device="cpu", seed=4)
        with torch.no_grad():
            model.bin_score.fill_(BIN_SCORE)
        out = model.forward_train(batch)
        out["loss"].backward()
        outs.append((out, torch_grads(model)))
    (m, gm), (c, gc) = outs
    np.testing.assert_allclose(c["loss"].item(), m["loss"].item(), rtol=1e-6)
    for key in ("matching_loss", "acc_corr", "acc_incorr", "total_acc_corr"):
        np.testing.assert_allclose(c[key].item(), m[key].item(), rtol=1e-6, err_msg=key)
    assert torch.equal(c["matches0"], m["matches0"])
    assert float(c["compaction_overflow0"]) == float(c["compaction_overflow1"]) == 0
    for name, g in gm.items():
        np.testing.assert_allclose(gc[name], g, rtol=1e-5, atol=1e-7, err_msg=name)


# ------------------------------------------------------------------ the unrolled loop
def test_unrolled_loop_under_batch_norm_matches_impx(batch):
    """norm_fn='bn': every MLP on batch statistics, one image at a time,
    against impx's _iterate(train=True) (attn_impl='xla')."""
    check_eimp(batch, XLA, n_pools=1, **{**LOOP, "norm_fn": "bn"})


def test_unrolled_loop_at_unequal_counts_matches_impx(batch):
    """N0 = 48, N1 = 40 (norm_fn='in') against impx's unrolled loop."""
    check_eimp(cut_image1(batch, 40), XLA, n_pools=1, **LOOP)


def test_routing_refusals(batch):
    """train_compaction off the scan raises ValueError, as impx's trainer
    does; so does train_supervision='last'; a schedule outside
    (0, n_layers) or whose buckets grow is refused."""
    for fields, data in ((dict(norm_fn="bn"), batch), (dict(log_ot=True), batch), ({}, cut_image1(batch, 40))):
        model = AdaGMN(MatcherConfig(**SMALL, **{**EIMP, **fields}, train_compaction=((4, 24),)), device="cpu")
        with pytest.raises(ValueError, match="train_compaction"):
            model.forward_train(data)
    with pytest.raises(ValueError, match="train_supervision"):
        AdaGMN(MatcherConfig(**SMALL, **EIMP, train_supervision="last"), device="cpu").forward_train(batch)
    with pytest.raises(ValueError, match="train_compaction"):
        MatcherConfig(**SMALL, **EIMP, train_compaction=((6, 24),))
    with pytest.raises(ValueError, match="must not grow"):
        AdaGMN(MatcherConfig(**SMALL, **EIMP, train_compaction=((2, 64),)), device="cpu").forward_train(batch)


# ------------------------------------------------------------------ log_ot
def test_log_ot_loop_equals_gm_training_without_pooling(batch):
    """Under log_ot with pooling off (first_it_to_update = n_layers) EIMP's
    loss is GM's: the port's AdaGMN.forward_train against impx's
    DGNNS.forward_train (GM's unrolled forward, attn_impl='xla') on the same
    params, loss and every gradient leaf. The port reads the log plan as a
    log plan; impx's EIMP loop does not (the next test)."""
    fields = dict(LOOP, log_ot=True, first_it_to_update=4)
    jmodel, params, tmodel, tcfg = pair(JaxDGNNS, AdaGMN, XLA, bin_score=BIN_SCORE, **fields)
    (loss, _), jgrads = jax_train(jmodel, params, batch)
    out = tmodel.forward_train(batch)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5)
    from impx_torch.tools.convert import params_from_jax
    want = params_from_jax(jax.tree.map(np.array, jgrads), tcfg)
    zero = in_zero_grad_leaves(tmodel)
    for name, g in torch_grads(tmodel).items():
        if not zero.search(name):
            np.testing.assert_allclose(g, want[name].numpy(), rtol=2e-3, atol=1e-5, err_msg=name)


def test_impx_eimp_log_ot_loss_is_not_the_log_plan_loss(batch):
    """impx's EIMP loop under log_ot passes the log plan to graph_loss
    without scores_are_log (impx/models/adgm.py:228-230), so its loss is
    that of log|log p|, not the port's on the same params, which the test
    above holds to GM's (ROADMAP section C)."""
    fields = dict(LOOP, log_ot=True, first_it_to_update=4)
    jmodel, params, tmodel, _ = pair(JaxAdaGMN, AdaGMN, XLA, bin_score=BIN_SCORE, **fields)
    jdata = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    eimp_loss = float(jax.jit(lambda p, d: jmodel.forward_train(p, d)["loss"])(params, jdata))
    with torch.no_grad():
        loss = tmodel.forward_train(batch)["loss"].item()
    assert np.isfinite(eimp_loss) and np.isfinite(loss)
    assert abs(eimp_loss - loss) > 0.1 * abs(loss)
