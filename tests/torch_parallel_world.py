"""Worlds of CPU ranks for the parallelism parity tests (not a test file).

`run_world(n, job, workdir, **payload)` saves the payload under workdir,
starts n processes of this module (one rank each, torch on one thread),
which meet over gloo at a file:// rendezvous in workdir (xdist runs test
files side by side, so no TCP port), run `JOBS[job](payload, rank, world)`
and save its dict; it returns the ranks' dicts in rank order. A failing
rank fails the call with its stderr. The ranks import torch and impx_torch
only; impx runs in the test process.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def run_world(n: int, job: str, workdir, timeout: float = 300, **payload) -> list:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(payload, workdir / "payload.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")])}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), job, str(r), str(n), str(workdir)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    errors = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errors.append(f"rank {r} exited {p.returncode}:\n{out[-3000:]}\n{err[-6000:]}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(n)]


# ------------------------------------------------------------------ the jobs
def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else x


def _build(payload, cls_name: str, sd_key: str = "state_dict", **cfg_extra):
    from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
    from impx_torch.models.gm import GM

    cfg = MatcherConfig(**{**payload["config"], **cfg_extra})
    model = {"GM": GM, "DGNNS": DGNNS, "AdaGMN": AdaGMN}[cls_name](cfg, device="cpu")
    model.load_state_dict(payload[sd_key])
    return model


def job_collectives(payload, rank, world):
    """Every collective of impx_torch.parallel.collectives on this rank's
    shard, batch_norm_train(group=) and the gradients of f, g, all_gather."""
    from impx_torch.ops.norms import batch_norm_train
    from impx_torch.parallel import collectives as col
    from impx_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh()
    g = mesh.group()
    x = torch.from_numpy(payload["x"])              # [world * 4]  -> [4] a rank
    mine = shard_batch(mesh, x)
    out = {"psum": col.psum(mine.sum(), g), "pmean": col.pmean(mine.sum(), g),
           "pmax": col.pmax(mine.max(), g), "all_gather": col.all_gather(mine, g),
           "all_gather_stacked": col.all_gather(mine, g, tiled=False),
           "reduce_scatter": col.reduce_scatter(torch.from_numpy(payload["rs"])[rank], g),
           "ring_shift": col.ring_shift(mine, g, shift=1),
           "ppermute": col.ppermute(mine, [(0, 1), (1, 2)], g),
           "axis_index": col.axis_index(g), "axis_size": col.axis_size(g),
           "under": col.under(mesh, lambda s: col.psum(s.sum(), g), x)}
    bx = shard_batch(mesh, torch.from_numpy(payload["bn_x"]))
    scale, bias = torch.from_numpy(payload["bn_scale"]), torch.from_numpy(payload["bn_bias"])
    out["bn"] = batch_norm_train(bx, scale, bias, group=g)
    mask = shard_batch(mesh, torch.from_numpy(payload["bn_mask"]))
    out["bn_masked_pmean"] = batch_norm_train(bx, scale, bias, mask=mask, group=g)
    out["bn_masked_global"] = batch_norm_train(bx, scale, bias, mask=mask, group=g, global_batch=True)
    # the global-moment norm's gradient: sum over ranks of <y, w>
    xg = bx.clone().requires_grad_(True)
    y, _, _ = batch_norm_train(xg, scale, bias, mask=mask, group=g, global_batch=True)
    (y * shard_batch(mesh, torch.from_numpy(payload["bn_w"]))).sum().backward()
    out["bn_global_grad"] = xg.grad
    # f, g and all_gather: closed forms of their gradients
    v = mine.clone().requires_grad_(True)
    (col.copy_to_group(v, g) * (rank + 1)).sum().backward()
    out["f_grad"] = v.grad
    v = mine.clone().requires_grad_(True)
    (col.reduce_from_group(v, g) * (rank + 1)).sum().backward()
    out["g_grad"], out["g_out"] = v.grad, col.reduce_from_group(mine, g)
    v = mine.clone().requires_grad_(True)
    w = torch.arange(world * 4, dtype=torch.float32) * (rank + 1)
    (col.all_gather(v, g) * w).sum().backward()
    out["all_gather_grad"] = v.grad
    # replicate: a module's and a list's tensors set to rank 0's
    from impx_torch.parallel.mesh import replicate

    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(rank + 1.0)
    tensors = [torch.full((3,), float(rank))]
    replicate(mesh, module)
    replicate(mesh, tensors)
    out["replicate_module"], out["replicate_list"] = module.weight.detach(), tensors[0]
    return {k: (tuple(_np(t) for t in val) if isinstance(val, tuple) else _np(val)) for k, val in out.items()}


class SyntheticReader:
    """StandardReader's interface (num_kpt, __len__, run(index)) over seeded
    pairs of impx_torch.data.synthetic, descriptors scaled by desc_scale."""

    def __init__(self, n_pairs: int, num_kpt: int, seed: int = 0, desc_dim: int = 32, n_inliers: int = 40,
                 n_outliers: int = 40, desc_scale: float = 16.0):
        from impx_torch.data.synthetic import synthesize_pair

        rs = np.random.RandomState(seed)
        self.pairs = [synthesize_pair(rs, n_inliers=n_inliers, n_outliers0=n_outliers, n_outliers1=n_outliers,
                                      desc_dim=desc_dim, image_size=(480, 640)) for _ in range(n_pairs)]
        self.num_kpt, self.desc_scale = num_kpt, desc_scale

    def __len__(self):
        return len(self.pairs)

    def run(self, index: int) -> dict:
        p, k = self.pairs[index], self.num_kpt
        t = p["T"] / (p["T"] ** 2).sum() ** 0.5
        return {"index": index, "K1": p["K1"], "K2": p["K2"], "R": p["R"], "t": t,
                "x1": p["kpt1"][:k], "x2": p["kpt2"][:k], "desc1": self.desc_scale * p["desc1"][:k],
                "desc2": self.desc_scale * p["desc2"][:k], "e": p["e"], "f": p["f"], "r_gt": p["R"],
                "t_gt": t, "img_size1": tuple(p["img_size1"]), "img_size2": tuple(p["img_size2"])}


class EvalArgs:
    max_pairs = -1
    bucket = -1
    eval_batch = 4
    pose_backend = "device"
    use_iterative = False
    use_uncertainty = False
    checkpoint_backend = "jax"
    ransac_hypotheses = 32
    data_parallel = False

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_eval(payload, **kw) -> dict:
    """evaluate over payload['eval'] (config, state_dict, reader arguments)
    with EvalArgs(**kw); the results without the timings."""
    from impx_torch.eval.eval_imp import evaluate
    from impx_torch.models import DGNNS, MatcherConfig

    spec = payload["eval"]
    model = DGNNS(MatcherConfig(**spec["config"]), device="cpu")
    model.load_state_dict(spec["state_dict"])
    reader = SyntheticReader(**spec["reader"])
    out = evaluate(model, reader, 1.0, {"seed": 0}, EvalArgs(**kw))
    return {k: v for k, v in out.items() if k not in ("pairs_per_sec_device", "total_time")}


def trainer_epoch(payload, save_path, **kw):
    """One epoch of the Trainer on SyntheticMegadepth (payload['trainer']);
    returns (its loss, the parameters after it in the full layout)."""
    import argparse

    from impx_torch.data.megadepth import SyntheticMegadepth
    from impx_torch.train.step import init_opt_state
    from impx_torch.train.trainer import Trainer
    from impx_torch.parallel.tp import gather_full

    spec = payload["trainer"]
    model = _build(spec, "DGNNS")
    args = argparse.Namespace(**{**spec["args"], "save_path": str(save_path), **kw})
    trainer = Trainer(model, SyntheticMegadepth(**spec["dataset"]), args)
    _, loss = trainer.process_epoch(init_opt_state(model))
    return loss, {k: _np(v) for k, v in gather_full(model, model.state_dict()).items()}


def job_dp(payload, rank, world):
    """The data-parallel step against the one-process step (the parent runs
    impx's), the trainer's epoch, an indivisible batch, eval --data_parallel."""
    from impx_torch.parallel.mesh import make_mesh, set_data_group, shard_batch
    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step
    from impx_torch.train.trainer import Trainer

    mesh = make_mesh()
    out = {}
    for name, case in payload["steps"].items():
        model = set_data_group(_build(case, "DGNNS"), mesh.group())
        step = make_train_step(model, TrainHyperParams(**case["hp"]))
        opt, stats, losses = init_opt_state(model), init_stats("cpu"), []
        mine = shard_batch(mesh, case["batch"])
        for it in range(case["n_steps"]):
            m, stats = step(opt, it, mine, stats)
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "params": {k: _np(v) for k, v in model.state_dict().items()},
                     "mu": {k: _np(v) for k, v in opt["mu"].items()}, "count": int(opt["count"])}
    out["trainer"] = trainer_epoch(payload, Path(payload["root"]) / "runs")
    try:
        import argparse

        from impx_torch.data.megadepth import SyntheticMegadepth

        spec = payload["trainer"]
        args = argparse.Namespace(**{**spec["args"], "batch_size": 3, "epochs": 1,
                                     "save_path": str(Path(payload["root"]) / "bad")})
        Trainer(_build(spec, "DGNNS"), SyntheticMegadepth(**spec["dataset"]), args).train()
        out["indivisible"] = None
    except SystemExit as e:
        out["indivisible"] = str(e)
    out["eval"] = run_eval(payload, data_parallel=True)
    out["eval_iterative"] = run_eval(payload, data_parallel=True, use_iterative=True)
    return out


def job_tp(payload, rank, world):
    """Tensor parallelism over a (world / 2, 2) grid: DGNNS's and AdaGMN's
    forward on this rank's data block, the training steps (in and bn) and
    the first one's gradient, the trainer's epoch at model parallelism 2 and
    its checkpoint."""
    from impx_torch.parallel.mesh import set_data_group, shard_batch
    from impx_torch.parallel.tp import gather_full, make_2d_mesh, shard_params_tp
    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

    mesh = make_2d_mesh(world // 2, 2)
    out = {"coords": mesh.coords}
    for name, case in payload["forward"].items():
        model = shard_params_tp(_build(case, case["cls"]), mesh)
        res = model.produce_matches(shard_batch(mesh, case["batch"]), p=0.2, only_last=True)
        out[name] = {k: _np(res[k][-1]) for k in ("indices0", "mscores0")}
        if "keep0" in res:
            out[name]["keep0"] = _np(res["keep0"])
    out["heads"] = model.gnn[0].num_heads
    for name, case in payload["steps"].items():
        model = set_data_group(shard_params_tp(_build(case, "DGNNS"), mesh), mesh.group("data"))
        step = make_train_step(model, TrainHyperParams(**case["hp"]))
        opt, stats, losses = init_opt_state(model), init_stats("cpu"), []
        mine = shard_batch(mesh, case["batch"])
        for it in range(case["n_steps"]):
            m, stats = step(opt, it, mine, stats)
            losses.append(float(m["loss"]))
            if it == 0:   # the gradient the first update applied
                grads = {k: _np(v) for k, v in gather_full(model, {n: p.grad for n, p in
                                                                   model.named_parameters()}).items()}
        out[name] = {"losses": losses, "grads": grads,
                     "params": {k: _np(v) for k, v in gather_full(model, model.state_dict()).items()},
                     "shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()}}
    if world == 2:
        import argparse

        from impx_torch.data.megadepth import SyntheticMegadepth
        from impx_torch.train.trainer import Trainer

        spec = payload["trainer"]
        args = argparse.Namespace(**{**spec["args"], "save_path": str(Path(payload["root"]) / "runs"),
                                     "model_parallel": 2})
        model = _build(spec, "DGNNS")
        trainer = Trainer(model, SyntheticMegadepth(**spec["dataset"]), args)
        opt, loss = trainer.process_epoch(init_opt_state(model))
        out["trainer"] = {"loss": loss, "checkpoint": trainer.save_checkpoint(opt, name="tp"),
                          "params": {k: _np(v) for k, v in gather_full(model, model.state_dict()).items()},
                          "shape": tuple(model.gnn[0].attn["q"].weight.shape)}
    return out


SP_GRIDS = {2: ((1, 2),), 4: ((2, 2), (1, 4))}


def _sp_model(case, mesh):
    """The case's model handed the grid's sequence group (and its data group
    when the data axis is split) and this rank's block of the batch."""
    from impx_torch.parallel.mesh import set_data_group, set_seq_group
    from impx_torch.parallel.tp import shard_batch_sp

    model = set_seq_group(_build(case, case["cls"]), mesh.group("model"))
    if mesh.size("data") > 1:
        set_data_group(model, mesh.group("data"))
    return model, shard_batch_sp(mesh, case["batch"])


def _sp_step(case, mesh) -> dict:
    """One make_train_step step: its global loss and the gradient it applied."""
    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

    model, mine = _sp_model(case, mesh)
    metrics, _ = make_train_step(model, TrainHyperParams(**case["hp"]))(init_opt_state(model), 0, mine,
                                                                         init_stats("cpu"))
    return {"loss": float(metrics["loss"]),
            "grads": {n: _np(torch.zeros_like(q) if q.grad is None else q.grad) for n, q in model.named_parameters()}}


def job_sp(payload, rank, world):
    """Sequence parallelism on each grid of SP_GRIDS[world]: the forward of
    every case in payload['forward'] whose grids hold this one, the training
    steps of payload['steps'] likewise, and at (1, 2) the step with the score
    head's gradient counted s times, two ways (payload['miscount'])."""
    from impx_torch.parallel import collectives
    from impx_torch.parallel.tp import make_2d_mesh

    out = {}
    for grid in SP_GRIDS[world]:
        mesh = make_2d_mesh(*grid)
        res = out[grid] = {"coords": mesh.coords}
        for name, case in payload["forward"].items():
            if grid in case["grids"]:
                model, mine = _sp_model(case, mesh)
                got = model.produce_matches(mine, p=0.2, only_last=True)
                res[name] = {k: _np(got[k][-1]) for k in ("indices0", "mscores0")}
                if "keep0" in got:
                    res[name].update(keep0=_np(got["keep0"]), keep1=_np(got["keep1"]))
        for name, case in payload["steps"].items():
            if grid in case["grids"]:
                res[f"step_{name}"] = _sp_step(case, mesh)
        if grid == (1, 2):
            case = payload["steps"]["in"]
            gather, once = collectives.gather_for_replicated, collectives.count_once
            collectives.gather_for_replicated = collectives.all_gather   # the head's rows: backward summed
            res["miscount_gather"] = _sp_step(case, mesh)
            collectives.gather_for_replicated = gather
            collectives.count_once = lambda x, group: x                  # the bin score: on every rank
            res["miscount_bin"] = _sp_step(case, mesh)
            collectives.count_once = once
    return out


def job_pp(payload, rank, world):
    """The GPipe forward for each (stages, microbatches) case: the stage
    ranks' outputs (None on a rank that is no stage)."""
    from impx_torch.parallel.pp import make_stage_mesh, pipeline_forward_scan

    model = _build(payload, "DGNNS")
    out = {}
    for n_stages, n_mb in payload["cases"]:
        mesh = make_stage_mesh(n_stages)
        res = pipeline_forward_scan(model, payload["data"], mesh, n_microbatches=n_mb, p=0.2)
        out[(n_stages, n_mb)] = None if res is None else {k: _np(res[k][0]) for k in ("indices0", "mscores0",
                                                                                      "scores")}
    return out


JOBS = {name[4:]: fn for name, fn in list(globals().items()) if name.startswith("job_")}


def _main(job: str, rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    from impx_torch.parallel.mesh import init_distributed

    init_distributed(f"file://{workdir}/rendezvous", rank=rank, world_size=world, device="cpu")
    payload = torch.load(Path(workdir) / "payload.pt", weights_only=False)
    out = JOBS[job](payload, rank, world)
    torch.save(out, Path(workdir) / f"out{rank}.pt")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
