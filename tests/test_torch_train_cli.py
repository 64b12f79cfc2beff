"""The training CLI and its datasets against impx on the CPU: Megadepth on a
small dump written by the port's MegadepthDumper, SyntheticMegadepth and
normalize_size_spg, the two parsers' flags and defaults, the refusals, three
steps of the CLI against impx's from one reference checkpoint, and the
SIGTERM preemption checkpoint with a resume from it.
"""
import argparse
import glob
import json
import os
import signal

import cv2
import h5py
import numpy as np
import pytest

import jax
import torch

import impx.train.trainer as jax_trainer_module
from impx.data import megadepth as jax_megadepth
from impx.models import DGNNS as JaxDGNNS
from impx.models import GM as JaxGM
from impx.models import MatcherConfig as JaxConfig
from impx.parallel.mesh import make_mesh
from impx.tools.convert_torch import matcher_state_dict
from impx.train import train as jax_train

from impx_torch.data import megadepth
from impx_torch.data.dump import dump_megadepth
from impx_torch.models import DGNNS, MatcherConfig
from impx_torch.train import train
from impx_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def restore_sigterm():
    """Both trainers install a SIGTERM handler; put the test runner's back."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


# ------------------------------------------------------------------ datasets
def _write_raw_scene(root, rs, scene="0000", n_imgs=3, h=360, w=480, shift=16, f=300.0, z=5.0):
    """MegaDepth's raw layout (image paths Undistorted_SfM/<scene>/images/...,
    the scene name second, as Megadepth reads it): a fronto-parallel textured
    plane at depth z seen by cameras moved sideways, image i the crop at
    column shift * i, so depth reprojection labels true correspondences."""
    big = cv2.GaussianBlur((rs.rand(h, w + shift * (n_imgs - 1)) * 255).astype(np.uint8), (0, 0), 1.5)
    sfm = f"Undistorted_SfM/{scene}"
    for sub in ("scene_info", f"{sfm}/images", f"{sfm}/depths"):
        os.makedirs(root / sub, exist_ok=True)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    images, depths, poses = [], [], []
    for i in range(n_imgs):
        images.append(f"{sfm}/images/{i}.png")
        depths.append(f"{sfm}/depths/{i}.h5")
        cv2.imwrite(str(root / images[-1]), big[:, shift * i: shift * i + w])
        with h5py.File(root / depths[-1], "w") as fh:
            fh["depth"] = np.full((h, w), z, np.float32)
        pose = np.eye(4)
        pose[0, 3] = -shift * i * z / f
        poses.append(pose)
    obj = lambda xs: np.array(xs + [None], dtype=object)[:-1]  # noqa: E731  (1-D object arrays)
    np.savez(root / "scene_info" / f"{scene}.0.npz", image_paths=obj(images), depth_paths=obj(depths),
             poses=np.stack(poses), intrinsics=np.stack([K] * n_imgs),
             overlap_matrix=0.5 * np.triu(np.ones((n_imgs, n_imgs)), 1),
             scale_ratio_matrix=np.ones((n_imgs, n_imgs)),
             points3D_id_to_2D=obj([{p: (0.0, 0.0) for p in range(30)} for _ in range(n_imgs)]))
    (root / "scenes.txt").write_text(scene + "\n")


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A RootSIFT dump (up to 4096 keypoints an image, 3 pairs: the dumper
    keeps a pair when both images hold 1024) of one raw scene, written by the
    port's MegadepthDumper."""
    root = tmp_path_factory.mktemp("megadepth")
    _write_raw_scene(root / "raw", np.random.RandomState(3))
    dump_megadepth.MegadepthDumper(dump_megadepth.parser.parse_args([
        "--base_path", str(root / "raw"), "--scene_list_fn", str(root / "raw" / "scenes.txt"),
        "--feature_type", "sift", "--save_dir", str(root / "dump"),
        "--device", "cpu"])).run()
    return root


def _assert_same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("random_inliers", [True, False])
def test_megadepth_matches_impx(dump, random_inliers):
    """Megadepth against impx's on the same dump, sample for sample, exactly:
    impx draws from numpy's global stream and the port from the
    RandomState it holds, both seeded with 5. The pair lists of epoch 0 and
    of the resampled epoch 1 are equal; validation samples (train=False)
    equal without any seeding; nfeatures beyond every image's keypoints
    probes every pair, remembers the same images as invalid and raises in
    both."""
    kw = dict(base_path=str(dump / "dump"), scene_list_fn=str(dump / "raw" / "scenes.txt"),
              pairs_per_scene=2, nfeatures=64, feature_type="sift", min_inliers=8, max_inliers=32,
              random_inliers=random_inliers)
    ours = megadepth.Megadepth(**kw, seed=5)
    theirs = jax_megadepth.Megadepth(**kw)
    np.random.seed(5)
    assert ours.dataset == theirs.dataset and len(ours) == 2
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        _assert_same_sample(a, b)
        assert a["matching_mask"].shape == (65, 65) and a["matching_mask"][:64, :64].sum() > 0
    ours.build_dataset(seed=1)
    theirs.build_dataset(seed=1)
    assert ours.dataset == theirs.dataset

    val = [cls(**kw, train=False) for cls in (megadepth.Megadepth, jax_megadepth.Megadepth)]
    assert val[0].dataset == val[1].dataset
    for i in range(len(val[0])):
        _assert_same_sample(val[0][i], val[1][i])

    invalid = []
    for cls in (megadepth.Megadepth, jax_megadepth.Megadepth):
        big = cls(**{**kw, "nfeatures": 100_000})
        with pytest.raises(RuntimeError, match="no valid training sample"):
            big[0]
        invalid.append(big.invalid_fns)
    assert invalid[0] == invalid[1] and invalid[0]


def test_data_parallel_ranks_assemble_the_one_process_rows_of_megadepth(dump, tmp_path, restore_sigterm):
    """Megadepth's training samples draw from one stream, so a rank that drew
    only its own rows would draw the first rows' numbers: each rank of a data
    axis of 2 draws every row of the batch and keeps its block, which equals
    the one-process batch's rows exactly."""
    kw = dict(base_path=str(dump / "dump"), scene_list_fn=str(dump / "raw" / "scenes.txt"),
              pairs_per_scene=2, nfeatures=64, feature_type="sift", min_inliers=8, max_inliers=32,
              random_inliers=True, seed=5)
    args = argparse.Namespace(lr=1e-4, network="dgnns", feature="sift", batch_size=2, epochs=1,
                              save_path=str(tmp_path))
    cfg = MatcherConfig(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=2, num_heads=4)

    def batches(d, n_data):
        trainer = Trainer(DGNNS(cfg, device="cpu"), megadepth.Megadepth(**kw), args)
        trainer._data_rows = lambda: (d, n_data)
        return list(trainer._batches_sync())

    one = batches(0, 1)
    assert len(one) == 1
    for d in range(2):
        (mine,) = batches(d, 2)
        for k, v in mine.items():
            np.testing.assert_array_equal(v.numpy(), one[0][k][d:d + 1].numpy(), err_msg=k)
    # the teeth: row 1 drawn first from the stream is not the one-process row 1
    alone = megadepth.Megadepth(**kw)[1]
    assert not np.array_equal(alone["matching_mask"], one[0]["matching_mask"][1].numpy())


def test_synthetic_megadepth_and_normalization_equal_impx():
    ours = megadepth.SyntheticMegadepth(num_pairs=4, nfeatures=24, desc_dim=32)
    theirs = jax_megadepth.SyntheticMegadepth(num_pairs=4, nfeatures=24, desc_dim=32)
    for epoch in (0, 2):
        ours.build_dataset(seed=epoch)
        theirs.build_dataset(seed=epoch)
        assert len(ours) == len(theirs) == 4
        for i in range(4):
            _assert_same_sample(ours[i], theirs[i])
    x = np.random.RandomState(0).rand(50, 2).astype(np.float32) * 640
    for size in ((640, 480), np.array([320, 240])):
        a = megadepth.normalize_size_spg(x, size)
        np.testing.assert_array_equal(a, jax_megadepth.normalize_size_spg(x, size))
        assert a.dtype == np.float32


# ------------------------------------------------------------------ the parser
def test_parser_flags_and_defaults_equal_impx():
    """impx's parser flag for flag, each default the same; the port adds
    --device only."""
    ours = {a.dest: a for a in train.parser._actions}
    theirs = {a.dest: a for a in jax_train.parser._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    for dest, action in theirs.items():
        assert ours[dest].default == action.default, dest
        assert ours[dest].option_strings == action.option_strings, dest
        assert ours[dest].choices == action.choices, dest


def test_config_merge_order_is_impx(tmp_path):
    """defaults < --config JSON (keys ending in '_' skipped) < explicit flags."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"layers": 3, "batch_size": 4, "lr_": 5.0, "network": "dgnns"}))
    argv = ["--config", str(cfg), "--batch_size", "6"]
    ours = train.parse_args(argv)
    assert (ours.layers, ours.batch_size, ours.lr, ours.network) == (3, 6, 1e-4, "dgnns")
    # impx's main merges inline (impx/train/train.py:165-172)
    ns = argparse.Namespace(**vars(jax_train.parser.parse_args([])))
    ns.__dict__.update({k: v for k, v in json.loads(cfg.read_text()).items() if not k.endswith("_")})
    theirs = vars(jax_train.parser.parse_args(argv, namespace=ns))
    assert theirs == {k: v for k, v in vars(ours).items() if k != "device"}


@pytest.mark.parametrize("flags,item", [
    (["--network", "adagmn"], "A7"), (["--norm_fn", "bn"], "A7"), (["--train_compaction", "1:16"], "A7"),
    (["--multihost"], "A11"), (["--model_parallel", "2"], "A11")],
    ids=["adagmn", "batch-norm", "train-compaction", "multihost", "model-parallel"])
def test_unported_flags_raise_naming_their_item(tmp_path, flags, item, restore_sigterm, monkeypatch):
    """The flags refused until their ROADMAP item was ported. Those of A7
    (EIMP training, batch norm in train mode) train: two steps on the CPU,
    finite losses, no kernel launch counted. Those of A11 (parallelism), in
    one process without a launcher: --multihost raises, naming the launcher's
    variables, and --model_parallel 2 raises SystemExit (2 does not divide
    the one process), each before a run directory is made."""
    argv = ["--synthetic", "--device", "cpu", "--save_path", str(tmp_path), *flags]
    if item == "A7":
        before = _launches()
        train.main([*argv, "--layers", "2", "--max_keypoints", "16", "--batch_size", "2", "--epochs", "1",
                    "--its_per_epoch", "2", "--log_intervals", "1", "--feature", "sift"])
        losses = _losses(tmp_path)[0]
        assert len(losses) == 2 and np.isfinite(losses).all()
        assert _launches() == before
        return
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if flags == ["--multihost"]:
        with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE not set"):
            train.main(argv)
    else:
        with pytest.raises(SystemExit, match="--model_parallel 2 does not divide the 1 processes"):
            train.main(argv)
    assert not os.listdir(tmp_path)


def _launches() -> list:
    """Every kernel wrapper's launch count."""
    from impx_torch.ops.kernels import attention, log_sinkhorn, sinkhorn

    return [fn.launches for fn in (attention.mha_fused, attention.mha_fused_lse, attention.mha_bwd,
                                   attention.mha_bwd_from_lse, attention.attention_key_mass,
                                   sinkhorn.sinkhorn_fused_stats, log_sinkhorn.log_sinkhorn_fused_stats)]


def test_cli_trains_eimp_with_compaction(tmp_path, restore_sigterm):
    """--network adagmn --train_compaction: two steps of the compacted EIMP
    trainer on --synthetic with --device cpu (4 layers, pooling from
    iteration 3 with n_min_tokens 8, a bucket of 24 of 32 keypoints before
    it): the schedule reaches the config, the losses are finite, the
    checkpoint is written, no kernel launch is counted."""
    before = _launches()
    trainer = train.main(["--synthetic", "--device", "cpu", "--save_path", str(tmp_path), "--network", "adagmn",
                          "--train_compaction", "3:24", "--layers", "4", "--n_min_tokens", "8", "--feature", "sift",
                          "--max_keypoints", "32", "--batch_size", "2", "--epochs", "1", "--its_per_epoch", "2",
                          "--log_intervals", "1"])
    cfg = trainer.model.config
    assert type(trainer.model).__name__ == "AdaGMN" and cfg.train_compaction == ((3, 24),)
    losses = _losses(tmp_path)[0]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.isfile(os.path.join(trainer.save_dir, "adagmn.00"))
    assert _launches() == before


def test_cli_trains_batch_norm(tmp_path, restore_sigterm):
    """--norm_fn bn (DGNNS): two steps on --synthetic with --device cpu, finite
    losses; the layers' running statistics are parameters that the steps
    move, as impx's optimizer moves them."""
    argv = ["--synthetic", "--device", "cpu", "--save_path", str(tmp_path), "--network", "dgnns", "--norm_fn", "bn",
            "--layers", "2", "--feature", "sift", "--max_keypoints", "32", "--batch_size", "2", "--epochs", "1",
            "--its_per_epoch", "2", "--log_intervals", "1"]
    trainer = train.main(argv)
    assert trainer.model.config.norm_fn == "bn"
    losses = _losses(tmp_path)[0]
    assert len(losses) == 2 and np.isfinite(losses).all()
    var = trainer.model.state_dict()["gnn.0.mlp.norms.0.bn_var"]
    assert not torch.equal(var, torch.ones_like(var))


def test_cli_needs_the_card_unless_cpu_is_named(tmp_path, monkeypatch, capsys, restore_sigterm):
    """Without a card the CLI raises unless --device cpu; impx's TPU-only
    knobs parse and print one line saying they are ignored."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--synthetic", "--save_path", str(tmp_path)])
    trainer = train.main(["--synthetic", "--device", "cpu", "--save_path", str(tmp_path), "--layers", "1",
                          "--max_keypoints", "16", "--batch_size", "2", "--epochs", "1", "--its_per_epoch", "1",
                          "--feature", "sift", "--attn_impl", "pallas", "--train_remat", "attn",
                          "--attn_block_q", "128", "--train_fused", "--log_ot"])
    lines = [x for x in capsys.readouterr().out.splitlines() if "no counterpart" in x]
    assert len(lines) == 1 and all(f in lines[0] for f in ("--attn_impl", "--train_remat", "--attn_block_q"))
    cfg = trainer.model.config
    assert cfg.train_fused and cfg.log_ot and type(trainer.model).__name__ == "GM"
    assert os.path.isfile(os.path.join(trainer.save_dir, "gm.00"))


# ------------------------------------------------------------------ the CLI against impx's
def _losses(save_path):
    (path,) = glob.glob(os.path.join(save_path, "*", "metrics.jsonl"))
    rows = [json.loads(line) for line in open(path)]
    return [r["loss"] for r in rows if "loss" in r], [r["matching_loss"] for r in rows if "loss" in r]


@pytest.mark.parametrize("network", ["gm", "dgnns"])
def test_cli_matches_impx(tmp_path, monkeypatch, network, restore_sigterm):
    """Three steps of each CLI (--synthetic, 2 layers, 32 keypoints, batch 2,
    lr 1e-3) from one reference checkpoint given as --weight_path, written
    from impx's init through impx/tools/convert_torch.py: the losses in
    metrics.jsonl within rtol 1e-4 (fp32 sums in another order, then Adam's
    steps on them). impx's compile cache is patched to a tmp_path directory
    (not enabled), and its trainer to a one-device mesh (the test process
    has eight virtual devices, which batch 2 does not divide)."""
    cfg = JaxConfig(descriptor_dim=128, n_layers=2, norm_fn="in")
    sharing = network == "dgnns"
    params = (JaxDGNNS if sharing else JaxGM)(cfg).init(jax.random.PRNGKey(3))
    ckpt = tmp_path / "ref.pth"
    torch.save({"model": matcher_state_dict(jax.tree.map(np.asarray, params), cfg, sharing)}, ckpt)
    argv = ["--synthetic", "--network", network, "--feature", "sift", "--layers", "2", "--max_keypoints", "32",
            "--batch_size", "2", "--epochs", "1", "--its_per_epoch", "3", "--log_intervals", "1",
            "--synthetic_pairs", "8", "--lr", "1e-3", "--weight_path", str(ckpt)]
    monkeypatch.setattr("impx.tools.compile_cache.enable", lambda *a, **k: str(tmp_path / "jax_cache"))
    monkeypatch.setattr(jax_trainer_module, "make_mesh", lambda: make_mesh(jax.devices()[:1]))
    jax_train.main([*argv, "--save_path", str(tmp_path / "impx")])
    trainer = train.main([*argv, "--save_path", str(tmp_path / "port"), "--device", "cpu"])
    ours, theirs = _losses(tmp_path / "port"), _losses(tmp_path / "impx")
    assert len(ours[0]) == len(theirs[0]) == 3
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert os.path.isfile(os.path.join(trainer.save_dir, f"{network}.00")) and trainer.iteration == 3
    assert not (tmp_path / "jax_cache").exists()


# ------------------------------------------------------------------ preemption
def _tiny_args(tmp_path, **kw):
    base = dict(lr=1e-4, network="dgnns", feature="spp", batch_size=8, epochs=3, save_path=str(tmp_path),
                max_keypoints=32, its_per_epoch=1000, log_intervals=2)
    return argparse.Namespace(**{**base, **kw})


def _tiny_model(seed=0):
    return DGNNS(MatcherConfig(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=2, num_heads=4,
                               norm_fn="in", sinkhorn_iterations=5), device="cpu", seed=seed)


def test_preemption_checkpoint_and_resume(tmp_path, restore_sigterm):
    """As tests/test_training.py:262: the handler the Trainer installs only
    sets a flag; train() then dispatches no step, writes {tag}.preempt and
    returns; a new Trainer restores identical parameters and optimizer state
    from it and trains on from the next epoch. A real SIGTERM sets the flag
    too."""
    model = _tiny_model()
    ds = megadepth.SyntheticMegadepth(num_pairs=64, nfeatures=32, desc_dim=32)
    trainer = Trainer(model, ds, _tiny_args(tmp_path))
    handler = signal.getsignal(signal.SIGTERM)
    assert callable(handler)
    handler(signal.SIGTERM, None)
    assert trainer._preempted
    opt = trainer.train()
    assert trainer.iteration == 0 and trainer.epoch == 0
    preempt = glob.glob(os.path.join(trainer.save_dir, "*.preempt"))
    assert len(preempt) == 1 and preempt[0].endswith(f"{trainer.tag}.preempt")
    assert "SIGTERM: preemption checkpoint" in open(os.path.join(trainer.save_dir, "log.txt")).read()

    other = _tiny_model(seed=7)
    trainer2 = Trainer(other, ds, _tiny_args(tmp_path, epochs=2, its_per_epoch=2))
    assert not trainer2._preempted
    opt2 = trainer2.restore_checkpoint(preempt[0])
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert torch.equal(opt2["count"], opt["count"])
    assert trainer2.epoch == 1
    opt2 = trainer2.train(opt2)
    assert trainer2.epoch == 2 and trainer2.iteration == 2 and int(opt2["count"]) == 2

    os.kill(os.getpid(), signal.SIGTERM)   # the handler of trainer2, installed last
    assert trainer2._preempted
