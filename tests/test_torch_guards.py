"""Guards of the port: it imports neither jax nor impx, its entry points need
a CUDA device unless told device='cpu', and its kernel wrappers count only
kernel launches."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from impx_torch.models import AdaGMN, DGNNS, MatcherConfig, SuperGlue
from impx_torch.models.gm import GM
from impx_torch.ops.kernels.attention import attention_key_mass, mha_fused
from impx_torch.ops.kernels.log_sinkhorn import log_sinkhorn_fused_stats
from impx_torch.ops.kernels.sinkhorn import sinkhorn_fused_stats

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "impx_torch"
SMALL = MatcherConfig(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=2,
                      num_heads=4, norm_fn="in")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "impx")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_impx_import_statically(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names += [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
    assert not [n for n in names if _forbidden(n)], names


def test_no_jax_or_impx_import_at_run_time():
    code = ("import sys, impx_torch.models, impx_torch.tools.convert, impx_torch.train.trainer, "
            "impx_torch.data.reader, impx_torch.data.synthetic, impx_torch.geometry, "
            "impx_torch.ransac.pose_solver, impx_torch.eval.evaluator, impx_torch.eval.eval_imp, "
            "impx_torch.eval.eval_full, impx_torch.eval.pipeline, impx_torch.eval.iterative, "
            "impx_torch.ransac.five_point, impx_torch.ransac.fundamental, impx_torch.models.superpoint, "
            "impx_torch.data.extractors, impx_torch.data.sift_native, impx_torch.tools.viz, impx_torch.demo, "
            "impx_torch.geometry.reprojection, impx_torch.geometry.misc, impx_torch.data.dump.dump, "
            "impx_torch.data.dump.download_data, impx_torch.data.dump.dump_megadepth, impx_torch.eval.reproduce, "
            "impx_torch.tools.superpoint_phases, impx_torch.data.synthetic_device, impx_torch.eval.iterative_fused, "
            "impx_torch.eval.iterative_refill, impx_torch.eval.iterative_staged, impx_torch.train.train, "
            "impx_torch.data.megadepth, impx_torch.parallel.mesh, impx_torch.parallel.collectives, "
            "impx_torch.parallel.tp, impx_torch.parallel.pp; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'impx')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_point_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DGNNS(SMALL)
    assert DGNNS(SMALL, device="cpu").device == torch.device("cpu")


def test_resolve_device_takes_the_launchers_local_rank(monkeypatch):
    """Under a launcher (torchrun sets LOCAL_RANK) each rank takes its own
    card; without one, the default card; without a card it raises whatever
    LOCAL_RANK says."""
    from impx_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device() == torch.device("cuda:3")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def test_parallel_modules_are_walked_by_the_import_guard():
    walked = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"parallel/mesh.py", "parallel/collectives.py", "parallel/tp.py", "parallel/pp.py"} <= walked


def test_eimp_entry_point_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaGMN(SMALL)
    assert AdaGMN(SMALL, device="cpu").device == torch.device("cpu")


def _small_pairs(b=1, n=16):
    rs = np.random.RandomState(0)
    data = {"descriptors0": rs.randn(b, n, 32), "descriptors1": rs.randn(b, n, 32),
            "norm_keypoints0": rs.rand(b, n, 2), "norm_keypoints1": rs.rand(b, n, 2),
            "scores0": rs.rand(b, n), "scores1": rs.rand(b, n)}
    return {k: v.astype(np.float32) for k, v in data.items()}


def test_cpu_path_counts_no_launch():
    data = _small_pairs()
    before = (mha_fused.launches, sinkhorn_fused_stats.launches)
    out = DGNNS(SMALL, device="cpu").produce_matches(data, only_last=True)
    assert out["indices0"][0].shape == (1, 16)
    assert (mha_fused.launches, sinkhorn_fused_stats.launches) == before


@pytest.mark.parametrize("compaction", [(), ((2, 8),)], ids=["mask-only", "compacted"])
def test_eimp_cpu_path_counts_no_launch(compaction):
    config = dataclasses.replace(SMALL, n_layers=4, n_min_tokens=4, compaction=compaction)
    kernels = (mha_fused, sinkhorn_fused_stats, attention_key_mass)
    before = [fn.launches for fn in kernels]
    out = AdaGMN(config, device="cpu").produce_matches(_small_pairs(), only_last=True)
    assert out["indices0"][0].shape == out["keep0"].shape == (1, 16)
    assert [fn.launches for fn in kernels] == before


def test_float64_arrays_run_as_fp32():
    rs = np.random.RandomState(1)
    b, n = 2, 24
    data = {"descriptors0": rs.randn(b, n, 32), "descriptors1": rs.randn(b, n, 32),
            "norm_keypoints0": rs.rand(b, n, 2), "norm_keypoints1": rs.rand(b, n, 2),
            "scores0": rs.rand(b, n), "scores1": rs.rand(b, n)}
    model = DGNNS(SMALL, device="cpu")
    out64 = model.produce_matches(data, only_last=True)
    out32 = model.produce_matches({k: v.astype(np.float32) for k, v in data.items()}, only_last=True)
    assert out64["mscores0"][0].dtype == out64["scores"][0].dtype == torch.float32
    assert torch.equal(out64["indices0"][0], out32["indices0"][0])
    assert torch.equal(out64["mscores0"][0], out32["mscores0"][0])


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        mha_fused(q, q, q)
    with pytest.raises(ValueError, match="no attention-mass kernel"):
        attention_key_mass(q, q)
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        sinkhorn_fused_stats(torch.empty((1, 4, 4), device="meta"), 1.0, 20)


@pytest.mark.parametrize("field,value", [("attn_block_q", 256), ("train_compaction", ((2, 8),)),
                                         ("train_remat", "attn")])
def test_unported_options_raise(field, value):
    """A config that names a field the port does not carry is refused, not run
    without it (attn_block_q and train_remat are choices of impx's TPU step).
    train_compaction is carried and checked: a schedule point outside
    (0, n_layers) raises ValueError (n_layers is 2 here)."""
    with pytest.raises(ValueError if field == "train_compaction" else TypeError, match=field):
        dataclasses.replace(SMALL, **{field: value})


def test_training_fields_are_validated():
    with pytest.raises(ValueError, match="train_supervision"):
        dataclasses.replace(SMALL, train_supervision="bogus")


def test_route_b_model_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = dataclasses.replace(SMALL, train_fused=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DGNNS(config)
    assert DGNNS(config, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["route-A", "route-B"])
def test_cpu_training_path_counts_no_launch(fused):
    from impx_torch.ops.kernels.attention import (
        mha_bwd, mha_bwd_from_lse, mha_fused_lse)

    data = _small_pairs(b=2)
    gt = np.zeros((2, 17, 17), np.float32)
    gt[:, np.arange(16), np.arange(16)] = 1
    data["matching_mask"] = gt
    kernels = (mha_fused, mha_fused_lse, mha_bwd, mha_bwd_from_lse)
    before = [fn.launches for fn in kernels]
    out = DGNNS(dataclasses.replace(SMALL, train_fused=fused), device="cpu").forward_train(data)
    out["loss"].backward()
    assert bool(torch.isfinite(out["loss"]))
    assert [fn.launches for fn in kernels] == before


def test_backward_wrappers_refuse_devices_without_a_kernel():
    from impx_torch.ops.kernels.attention import mha_bwd, mha_bwd_from_lse, mha_fused_lse

    q = torch.empty((1, 1, 4, 64), device="meta")
    lse = torch.empty((1, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        mha_fused_lse(q, q, q)
    with pytest.raises(ValueError, match="no attention backward kernel"):
        mha_bwd(q, q, q, None, q)
    with pytest.raises(ValueError, match="no attention backward kernel"):
        mha_bwd_from_lse(q, q, q, None, lse, q, q)


SMALL_BN = dataclasses.replace(SMALL, norm_fn="bn")


ALL_KERNELS = ("mha_fused", "mha_fused_lse", "mha_bwd", "mha_bwd_from_lse", "attention_key_mass",
               "sinkhorn_fused_stats", "log_sinkhorn_fused_stats")


def _cpu_training_step(model, call=None):
    """One forward_train (or `call`) and backward on CPU tensors: the loss is
    finite and no kernel wrapper counts a launch (they run their plain
    versions there)."""
    import impx_torch.ops.kernels.attention as ka
    import impx_torch.ops.kernels.log_sinkhorn as kl
    import impx_torch.ops.kernels.sinkhorn as ks

    kernels = [getattr(m, name) for name in ALL_KERNELS for m in (ka, ks, kl) if hasattr(m, name)]
    data = _small_pairs(b=2)
    gt = np.zeros((2, 17, 17), np.float32)
    gt[:, np.arange(8), np.arange(8)] = 1
    gt[:, np.arange(8, 16), 16] = gt[:, 16, np.arange(8, 16)] = 1
    data["matching_mask"] = gt
    before = [fn.launches for fn in kernels]
    out = (call or model.forward_train)(data)
    out["loss"].backward()
    assert bool(torch.isfinite(out["loss"]))
    assert any(p.grad is not None and p.grad.abs().sum() > 0 for p in model.parameters())
    assert [fn.launches for fn in kernels] == before


def test_log_ot_training_raises():
    """log_ot training runs on every route now, EIMP's unrolled loop and
    batch norm in train mode included (it raised before they were ported):
    a finite loss on the CPU and no kernel launch counted."""
    for model, config in ((AdaGMN, SMALL), (DGNNS, SMALL_BN), (AdaGMN, SMALL_BN)):
        _cpu_training_step(model(dataclasses.replace(config, log_ot=True), device="cpu"))


@pytest.mark.parametrize("model,config,item", [
    (DGNNS, SMALL_BN, "A7"), (AdaGMN, SMALL_BN, "A7"), (AdaGMN, SMALL, "A7"), (SuperGlue, SMALL_BN, "A7"),
    (GM, SMALL_BN, "A7")],
    ids=["dgnns-bn", "eimp-bn", "eimp", "superglue", "gm-bn"])
def test_unported_training_routes_raise(model, config, item):
    """The training routes of ROADMAP item A7, which raised until they were
    ported (batch norm in train mode for GM, DGNNS and SuperGlue; EIMP's
    trainer), now train through forward_train and through the reference's
    dispatch model(data, training=True): a finite loss on the CPU and no
    kernel launch counted (tests/test_torch_train_bn.py and
    tests/test_torch_train_eimp.py hold them against impx)."""
    m = model(config, device="cpu")
    for call in (m.forward_train, lambda d: m(d, training=True)):
        m.zero_grad(set_to_none=True)
        _cpu_training_step(m, call)


def test_batch_norm_models_are_built_in_eval_mode():
    """Batch norm models are built in eval mode, which chooses nothing: each
    call names its statistics (inference the running ones), so a model put
    in training mode matches exactly as in eval mode."""
    for cls in (DGNNS, AdaGMN):
        model = cls(SMALL_BN, device="cpu")
        assert not model.training
        ref = model.produce_matches(_small_pairs())
        out = model.train().produce_matches(_small_pairs())
        for a, r in zip(out["indices0"], ref["indices0"]):
            assert torch.equal(a, r)


def test_superglue_entry_point_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuperGlue(SMALL_BN)
    model = SuperGlue(SMALL_BN, device="cpu")
    assert model.device == torch.device("cpu") and not model.training


def test_superglue_in_training_mode_raises():
    """It raised before batch norm in train mode was ported; now the module's
    mode chooses nothing: SuperGlue in training mode matches from its running
    statistics, as in eval mode."""
    model = SuperGlue(SMALL_BN, device="cpu")
    ref = model.produce_matches(_small_pairs(), only_last=True)
    out = model.train().produce_matches(_small_pairs(), only_last=True)
    assert torch.equal(out["indices0"][0], ref["indices0"][0])
    assert torch.equal(out["scores"][0], ref["scores"][0])


def test_log_sinkhorn_wrapper_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no log-Sinkhorn kernel"):
        log_sinkhorn_fused_stats(torch.empty((1, 4, 4), device="meta"), 1.0, 20)


def test_cpu_log_paths_count_no_launch():
    data = _small_pairs()
    kernels = (mha_fused, sinkhorn_fused_stats, log_sinkhorn_fused_stats)
    before = [fn.launches for fn in kernels]
    out = DGNNS(dataclasses.replace(SMALL, log_ot=True), device="cpu").produce_matches(data, only_last=True)
    assert out["scores"][0].shape == (1, 17, 17)
    out = SuperGlue(SMALL_BN, device="cpu").produce_matches(data, only_last=True)
    assert out["indices0"][0].shape == (1, 16)
    assert [fn.launches for fn in kernels] == before


@pytest.mark.parametrize("mask_dtype,dtype,want", [
    (torch.bool, torch.bfloat16, torch.bool), (torch.uint8, torch.bfloat16, torch.bool),
    (torch.float32, torch.bfloat16, torch.bool), (torch.bool, torch.float32, torch.bool),
    (None, torch.bfloat16, None), (torch.float32, torch.float32, torch.bool)])
def test_forward_mask_is_read_in_place_by_the_bf16_kernel(mask_dtype, dtype, want):
    """Kernels 1 and 4, at bf16 and at fp32 (`dtype`, which no longer changes
    the mask), read a bool key mask one byte a key: the wrapper hands over the
    caller's tensor, with no cast; any other mask becomes its entries > 0, as
    impx reads it (a negative entry is a masked key)."""
    from impx_torch.ops.kernels.attention import _bool_mask

    mask = None
    if mask_dtype is not None:
        mask = torch.tensor([[1, 1, 2, 0, 1, -1, 1, 0, 1, 1]] * 2).to(mask_dtype)
        if mask_dtype == torch.bool:
            mask = (torch.arange(10)[None] < 7).repeat(2, 1)
    got = _bool_mask(mask)
    if mask is None:
        assert got is None
        return
    assert got.dtype == want and got.is_contiguous()
    assert (got.data_ptr() == mask.data_ptr()) == (mask_dtype == want)
    assert torch.equal(got, mask > 0 if mask_dtype.is_floating_point else mask.bool())


class _KernelLibrary:
    """Stands in for a built kernel library: the schedule query and the launch
    each return a given cudaError_t."""

    def __init__(self, schedule_err: int, launch_err: int):
        self.schedule_err, self.launch_err = schedule_err, launch_err

    def _schedule(self, b, n, m, bf16, out):
        out[:] = [b, b, b * (n + 1), 0, -(-(m + 1) // 8) * 8, 4096, n + 1, 1]
        return self.schedule_err

    def _launch(self, *args):
        return self.launch_err

    impx_sinkhorn_schedule = impx_log_sinkhorn_schedule = _schedule
    impx_sinkhorn_stats = impx_log_sinkhorn_stats = _launch


@pytest.mark.parametrize("kernel", ["sinkhorn", "log_sinkhorn"])
@pytest.mark.parametrize("schedule_err,launch_err", [(82, 0), (0, 82), (0, 719)],
                         ids=["no-cooperative-grid", "launch-too-large", "launch-failure"])
def test_sinkhorn_wrappers_raise_when_the_launch_reports_an_error(monkeypatch, kernel, schedule_err,
                                                                  launch_err):
    """Kernels 2 and 7 raise through `_build.check` when the card cannot hold
    the cooperative grid or the launch reports an error, and never fall back
    to their plain versions."""
    from impx_torch.ops.kernels import _build
    from impx_torch.ops.kernels import log_sinkhorn as kl
    from impx_torch.ops.kernels import sinkhorn as ks

    module = ks if kernel == "sinkhorn" else kl
    monkeypatch.setattr(_build, "load", lambda name: _KernelLibrary(schedule_err, launch_err))

    def fell_back(*args, **kwargs):
        raise AssertionError("the wrapper fell back to its plain version")

    monkeypatch.setattr(ks, "sinkhorn_stats_reference", fell_back)
    monkeypatch.setattr(kl, "log_sinkhorn_stats_reference", fell_back)
    dist = torch.zeros((2, 5, 7))
    mask0, mask1 = torch.ones((2, 5), dtype=torch.bool), torch.ones((2, 7), dtype=torch.bool)
    fn = getattr(module, f"{kernel}_fused_stats")
    before = fn.launches
    with pytest.raises(RuntimeError, match=f"CUDA error {schedule_err or launch_err}"):
        module._launch(dist, torch.ones(1), 20, mask0, mask1, 0)
    assert fn.launches == before + (0 if schedule_err else 1)


def test_eval_path_imports_and_runs_without_cv2_h5py_yaml():
    """The eval modules import without OpenCV, h5py and PyYAML (the card's
    machine has no h5py), and the device pose backend runs."""
    code = ("import sys\n"
            "sys.modules['cv2'] = sys.modules['h5py'] = sys.modules['yaml'] = None\n"
            "import numpy as np, torch\n"
            "import impx_torch.eval.eval_imp, impx_torch.eval.eval_full, impx_torch.eval.pipeline\n"
            "import impx_torch.eval.iterative, impx_torch.ransac.five_point\n"
            "from impx_torch.ransac.pose_solver import estimate_pose_device\n"
            "rs = np.random.RandomState(0)\n"
            "X = rs.randn(64, 3) * [2, 2, 1] + [0, 0, 6]\n"
            "x0 = torch.tensor(X[:, :2] / X[:, 2:], dtype=torch.float32)\n"
            "X1 = X + [0.5, 0.0, 0.1]\n"
            "x1 = torch.tensor(X1[:, :2] / X1[:, 2:], dtype=torch.float32)\n"
            "out = estimate_pose_device(torch.Generator().manual_seed(0), x0, x1,\n"
            "                           torch.ones(64, dtype=torch.bool), 1e-3, num_hypotheses=64)\n"
            "assert int(out['num_inliers']) > 60, out['num_inliers']\n"
            "bad = sorted(m for m in ('cv2', 'h5py', 'yaml') if sys.modules.get(m) is not None)\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("flag,item", [(["--data_parallel"], "A11")],
                         ids=lambda v: v if isinstance(v, str) else v[0])
def test_unported_eval_flags_raise(flag, item, tiny_eval_config):
    """The eval CLI's flags of ROADMAP item A11, refused until it was ported,
    now run: outside a process group (world size 1) --data_parallel changes
    nothing, as impx on one device, so the CLI returns the results of the
    run without it (timings aside)."""
    from impx_torch.eval import eval_imp

    argv = ["--device", "cpu", "--config_path", tiny_eval_config, "--layers", "2", "--bucket", "64",
            "--eval_batch", "2"]
    timing = ("pairs_per_sec_device", "total_time")
    plain = {k: v for k, v in eval_imp.main(argv).items() if k not in timing}
    assert {k: v for k, v in eval_imp.main([*argv, *flag]).items() if k not in timing} == plain
    assert item == "A11"


def test_five_point_sampling_runs():
    """sample_size=5 runs the five-point solver in every RANSAC entry point."""
    from impx_torch.ransac.pose_solver import estimate_pose_device
    from impx_torch.ransac.ransac import essential_ransac_from_samples, estimate_essential_ransac

    rs = np.random.RandomState(0)
    X = rs.randn(32, 3) * [2, 2, 1] + [0, 0, 6]
    x0 = torch.tensor(X[:, :2] / X[:, 2:], dtype=torch.float32)
    X1 = X + [0.5, 0.0, 0.1]
    x1 = torch.tensor(X1[:, :2] / X1[:, 2:], dtype=torch.float32)
    valid = torch.ones(32, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    for out in (estimate_essential_ransac(g, x0, x1, valid, 1e-3, num_hypotheses=16, sample_size=5),
                estimate_pose_device(g, x0, x1, valid, 1e-3, num_hypotheses=16, sample_size=5),
                essential_ransac_from_samples(torch.randint(0, 32, (16, 5), generator=g), x0, x1, valid, 1e-3)):
        assert int(out["num_inliers"]) >= 30 and bool(torch.isfinite(out["E"]).all())


@pytest.fixture(scope="module")
def tiny_eval_config(tmp_path_factory):
    """A YAML eval config over a synthetic HDF5 of 2 pairs, 48 keypoints."""
    import yaml

    from impx_torch.data.synthetic import write_eval_hdf5

    root = tmp_path_factory.mktemp("cli")
    write_eval_hdf5(str(root / "synth.hdf5"), num_pairs=2, seed=0, n_inliers=24, n_outliers0=24,
                    n_outliers1=24)
    config = {"reader": {"rawdata_dir": str(root), "dataset_dir": str(root / "synth.hdf5"), "num_kpt": 48},
              "evaluator": {"rescale": 640, "inlier_th": 0.005}}
    (root / "eval.yaml").write_text(yaml.safe_dump(config))
    return str(root / "eval.yaml")


ITERATIVE_FLAGS = [["--use_iterative"], ["--use_iterative", "--use_uncertainty", "--matching_method", "EIMP"],
                   ["--use_iterative", "--checkpoint_backend", "cv2", "--eval_batch", "1"]]


@pytest.mark.parametrize("flags", ITERATIVE_FLAGS, ids=["--use_iterative", "--use_uncertainty",
                                                        "--checkpoint_backend"])
def test_iterative_eval_flags_run(tiny_eval_config, flags):
    """The iterative loop's flags run the CLI on the CPU (--device cpu), its
    kernel wrappers counting no launch there."""
    from impx_torch.eval import eval_imp

    kernels = (mha_fused, sinkhorn_fused_stats, attention_key_mass)
    before = [fn.launches for fn in kernels]
    out = eval_imp.main(["--device", "cpu", "--config_path", tiny_eval_config, "--layers", "4",
                         "--ransac_hypotheses", "32", "--bucket", "64", *flags])
    assert 1 <= out["mean_stop_iteration"] <= 4 and out["precision"] >= 0
    assert [fn.launches for fn in kernels] == before


def test_iterative_eval_needs_cuda_unless_cpu_is_named(monkeypatch, tiny_eval_config):
    from impx_torch.eval import eval_imp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_imp.main(["--config_path", tiny_eval_config, "--layers", "4", "--use_iterative"])


def test_uncertainty_needs_an_eimp_model():
    from impx_torch.eval.iterative import IterativeMatcher

    with pytest.raises(ValueError, match="AdaGMN"):
        IterativeMatcher(DGNNS(SMALL, device="cpu"), norm_thresh=1e-3, with_uncertainty=True)


@pytest.mark.parametrize("backend", ["jax", "device"])
def test_device_fundamental_backend_needs_cuda_unless_a_device_is_named(monkeypatch, backend):
    from impx_torch.eval.evaluator import FMBenchEval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FMBenchEval({"f_backend": backend, "inlier_th": 1.0})
    assert FMBenchEval({"f_backend": backend}, device="cpu").device == torch.device("cpu")
    assert FMBenchEval({"f_backend": "cv2"}).device is None
    with pytest.raises(ValueError, match="f_backend"):
        FMBenchEval({"f_backend": "magsac"})


@pytest.mark.parametrize("backend", ["device", "jax"])
def test_device_pose_backend_needs_cuda_unless_a_device_is_named(monkeypatch, backend):
    from impx_torch.eval.evaluator import AucEval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AucEval({"pose_backend": backend, "inlier_th": 0.005})
    assert AucEval({"pose_backend": backend}, device="cpu").device == torch.device("cpu")
    assert AucEval({"pose_backend": "cv2"}).device is None
    with pytest.raises(ValueError, match="pose_backend"):
        AucEval({"pose_backend": "magsac"})


def test_frontend_imports_and_runs_without_cv2_h5py_yaml():
    """The front end's modules (SuperPoint, the extractors, the demo, the
    dumps, reproduce, viz) import without OpenCV, h5py and PyYAML, and
    SuperPoint extracts."""
    code = ("import sys\n"
            "sys.modules['cv2'] = sys.modules['h5py'] = sys.modules['yaml'] = None\n"
            "import numpy as np, torch\n"
            "import impx_torch.demo, impx_torch.eval.reproduce, impx_torch.tools.viz\n"
            "import impx_torch.data.dump, impx_torch.data.dump.dump, impx_torch.data.dump.dump_megadepth\n"
            "import impx_torch.data.dump.download_data, impx_torch.data.sift_native\n"
            "from impx_torch.data.extractors import ExtractSuperpoint\n"
            "from impx_torch.models.superpoint import SuperPoint\n"
            "out = SuperPoint(device='cpu')(np.random.RandomState(0).rand(1, 40, 48), max_keypoints=16)\n"
            "assert out['keypoints'].shape == (1, 16, 2) and out['descriptors'].shape == (1, 16, 256)\n"
            "ExtractSuperpoint({'num_kpt': 8}, device='cpu')\n"
            "bad = sorted(m for m in ('cv2', 'h5py', 'yaml') if sys.modules.get(m) is not None)\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _two_images(tmp_path):
    import cv2

    rs = np.random.RandomState(0)
    img = cv2.GaussianBlur((rs.rand(64, 96) * 255).astype(np.uint8), (0, 0), 1.5)
    paths = [str(tmp_path / "a.png"), str(tmp_path / "b.png")]
    cv2.imwrite(paths[0], img)
    cv2.imwrite(paths[1], np.roll(img, 4, axis=1))
    return paths


@pytest.mark.parametrize("entry", ["SuperPoint", "ExtractSuperpoint", "demo"])
def test_frontend_entry_points_need_cuda_unless_a_device_is_named(monkeypatch, tmp_path, entry):
    from impx_torch import demo
    from impx_torch.data.extractors import ExtractSuperpoint
    from impx_torch.models.superpoint import SuperPoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _two_images(tmp_path)
    calls = {
        "SuperPoint": lambda *dev: SuperPoint(device=dev[0] if dev else None).device,
        "ExtractSuperpoint": lambda *dev: ExtractSuperpoint({"num_kpt": 8}, *dev).device,
        "demo": lambda *dev: demo.main(["--image0", a, "--image1", b, "--output", str(tmp_path / "m.png"),
                                        "--num_kpt", "64", *(("--device", dev[0]) if dev else ())]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    out = calls[entry]("cpu")
    if entry == "demo":
        assert out["features"][0] > 0 and (tmp_path / "m.png").is_file()
    else:
        assert out == torch.device("cpu")
    if entry == "ExtractSuperpoint":
        assert ExtractSuperpoint({"num_kpt": 8, "device": "cpu"}).device == torch.device("cpu")


def test_missing_superpoint_weights_raise_file_not_found(tmp_path):
    """As impx's extractor: the weights are read on the first run, and a
    missing file raises FileNotFoundError naming it; so does the demo's
    --feature spp."""
    from impx_torch import demo
    from impx_torch.data.extractors import ExtractSuperpoint

    missing = str(tmp_path / "superpoint_v1.pth")
    ex = ExtractSuperpoint({"num_kpt": 8, "weight_path": missing}, device="cpu")
    with pytest.raises(FileNotFoundError, match="superpoint_v1.pth"):
        ex.run(np.zeros((32, 32), np.uint8))
    a, b = _two_images(tmp_path)
    with pytest.raises(FileNotFoundError, match="superpoint_v1.pth"):
        demo.main(["--image0", a, "--image1", b, "--feature", "spp", "--sp_weights", missing, "--device", "cpu"])


def test_device_synthesis_needs_cuda_unless_cpu_is_named(monkeypatch):
    from impx_torch.data.synthetic_device import synthesize_feed_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthesize_feed_device(torch.Generator(), 1, 8, 4)
    feed, _, _ = synthesize_feed_device(torch.Generator(), 1, 8, 4, device="cpu")
    assert feed["descriptors0"].device == torch.device("cpu")


@pytest.mark.parametrize("loop", ["fused", "refill", "staged"])
def test_queue_loops_on_a_cpu_model_count_no_launch(loop):
    """The loops run on their model's device, which needs CUDA unless the CPU
    is named (test_entry_point_needs_cuda_unless_cpu_is_named); on the CPU
    they count no kernel launch."""
    from impx_torch.data.synthetic_device import synthesize_feed_device
    from impx_torch.eval.iterative_fused import run_iterative_fused
    from impx_torch.eval.iterative_refill import run_iterative_refill
    from impx_torch.eval.iterative_staged import run_iterative_staged

    config = dataclasses.replace(SMALL, n_layers=4, n_min_tokens=4)
    model = (AdaGMN if loop == "fused" else DGNNS)(config, device="cpu")
    feed, _, _ = synthesize_feed_device(torch.Generator().manual_seed(0), 3, 16, 32, device="cpu")
    feed["norm_threshs"] = torch.full((3,), 2e-3)
    kernels = (mha_fused, sinkhorn_fused_stats, attention_key_mass)
    before = [fn.launches for fn in kernels]
    kw = dict(valid_its=(1, 3), min_kpts=2, num_hypotheses=8)
    if loop == "fused":
        out = run_iterative_fused(model, feed, 0, feed["norm_threshs"], with_uncertainty=True, **kw)
    elif loop == "refill":
        out = run_iterative_refill(model, feed, 0, slots=2, **kw)
    else:
        out = run_iterative_staged(model, feed, 0, batch=2, **kw)
    assert out["indices0"].shape == (3, 16) and out["indices0"].device == torch.device("cpu")
    assert out["checkpoints"] > 0
    assert [fn.launches for fn in kernels] == before


SLICE_19_MODULES = ("impx_torch.tools.export", "impx_torch.tools.profiling", "impx_torch.tools.image",
                    "impx_torch.tools.video", "impx_torch.tools.common", "impx_torch.tools.make_scene_lists",
                    "impx_torch.eval.pose_study", "impx_torch.eval.fm_study", "impx_torch.eval.geo_study",
                    "impx_torch.parallel.tp", "impx_torch.ops.kernels")


def test_sp_export_tools_and_studies_import_neither_jax_nor_impx():
    """The sequence-parallel, export, tool and study modules, imported in a
    fresh process (and walked by the static guard above)."""
    walked = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {f"{m.split('.', 1)[1].replace('.', '/')}.py" for m in SLICE_19_MODULES[:-1]} <= walked
    code = (f"import sys, {', '.join(SLICE_19_MODULES)}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'impx')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_studies_need_cuda_unless_cpu_is_named(monkeypatch):
    """The studies' device backends and geo_study's matchers take the card
    by default and raise without one; --device cpu runs them."""
    from impx_torch.eval import fm_study, geo_study, pose_study

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = [pose_study.synth_pair(np.random.RandomState(0), 30, 1.0, 0.0)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pose_study.run_backend("torch8", pairs)
    assert len(pose_study.run_backend("torch8", pairs, num_hypotheses=16, device="cpu")) == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fm_study.study(trials=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        geo_study.main(["--fast"])


def test_exported_ops_refuse_devices_without_a_kernel():
    """The kernel ops behind the wrappers: kernel 4's and kernel 7's wrappers
    refuse a meta tensor as the others do (the export traces fake tensors,
    whose device is the real one)."""
    from impx_torch.ops.kernels.attention import mha_fused_lse

    q = torch.empty((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        mha_fused_lse(q, q, q)
    with pytest.raises(ValueError, match="no log-Sinkhorn kernel"):
        log_sinkhorn_fused_stats(torch.empty((1, 4, 4), device="meta"), 1.0, 20)
