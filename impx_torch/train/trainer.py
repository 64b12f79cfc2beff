"""Training loop: epochs, metrics, checkpoints (impx/train/trainer.py).

As impx's trainer:
  * the learning-rate decay and the NaN guard run inside the step
    (impx_torch/train/step.py); the hot loop reads nothing back from the
    device except once per `log_intervals` steps;
  * an epoch aborts after 10 non-finite losses in a row, counted across log
    intervals (impx/train/trainer.py:267-273), and is then run again;
  * a checkpoint after every epoch, and the best one (higher value is
    better) kept apart;
  * the run directory is named from a timestamp and the hyperparameters;
  * metrics go to the console, log.txt and metrics.jsonl (and TensorBoard
    when tensorboardX is installed);
  * the dataset is duck-typed (`__len__`, `__getitem__` returning numpy
    dicts, an optional `build_dataset(seed)` called with the next epoch);
  * a background thread assembles the next batches, and an exception there is
    raised in the training loop;
  * SIGTERM (a preemption notice) sets a flag, in a handler installed from
    the main thread only; the epoch stops dispatching steps, `train` saves
    `{tag}.preempt` and returns, and `restore_checkpoint` resumes from it
    (impx/train/trainer.py:129-140, 249-250, 320-326).
Checkpoints are `torch.save` files of the parameters, the optimizer state
and the meta (epoch, iteration, best value).

Parallelism (impx/train/trainer.py:85-102, :286-313). In a process group
(impx_torch/parallel/mesh.py:init_distributed) the mesh comes from the
world: (data,) over every rank, or (data, model) with args.model_parallel
= k > 1 (SystemExit when k does not divide the world). The model's MLPs and
losses get the data group (global batch-norm moments, loss shares, one
gradient all-reduce a step: impx_torch/train/step.py), and under k > 1
its weights are sliced over the model group (impx_torch/parallel/tp.py).
train() raises SystemExit when the batch does not divide over the data
axis. Each rank's data thread assembles only its rows of the same global
batch one process would assemble (rank d of the data axis takes the d-th
contiguous block; where the samples draw from one stream, as Megadepth's in
training, each rank draws every row of the batch to keep the stream's
order), so an epoch's loss is the one-process loss. Rank 0
alone writes log.txt, metrics.jsonl and the checkpoints, which hold the
full single-device layout, gathered from the shards under tensor
parallelism: a run saved at one world size resumes at another. The SIGTERM
flag is agreed between the ranks before every step (a max over a gloo group
of the host), so every rank stops at the same step.
"""
from __future__ import annotations

import datetime
import json
import os
import os.path as osp
import queue
import signal
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

import torch.distributed as dist

from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step


class MetricWriter:
    """Console + log.txt + metrics.jsonl (+ TensorBoard when available)."""

    def __init__(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        self.log_file = open(osp.join(save_dir, "log.txt"), "a+")
        self.jsonl = open(osp.join(save_dir, "metrics.jsonl"), "a+")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(save_dir)

    def write(self, step: int, metrics: dict[str, float], prefix: str = ""):
        payload = {"step": step, **{prefix + k: float(v) for k, v in metrics.items()}}
        self.jsonl.write(json.dumps(payload) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(prefix + k, float(v), global_step=step)

    def text(self, msg: str):
        print(msg)
        self.log_file.write(msg + "\n")
        self.log_file.flush()

    def close(self):
        self.log_file.close()
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class _Silent:
    """The writer of a rank other than 0: writes nothing."""

    def write(self, *args, **kwargs):
        pass

    def text(self, msg: str):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, model, dataset, args: Any, eval_fn: Callable | None = None):
        """model: an impx_torch matcher with forward_train; dataset as the
        module docstring says; args: lr, network, feature, batch_size, epochs,
        save_path and optionally min_lr, decay_rate, decay_iter, optim,
        weight_decay, its_per_epoch, log_intervals, max_keypoints;
        eval_fn(model) -> dict of scalars (higher is better). In a process
        group the model must hold the same full weights on every rank; under
        model_parallel > 1 they are sliced here."""
        self.model = model
        self._setup_parallel(int(getattr(args, "model_parallel", 1) or 1))
        self.dataset = dataset
        self.args = args
        self.eval_fn = eval_fn
        self.hp = TrainHyperParams(
            lr=args.lr, min_lr=getattr(args, "min_lr", 1e-6),
            decay_rate=getattr(args, "decay_rate", 0.999992),
            decay_iter=getattr(args, "decay_iter", 200_000),
            optim=getattr(args, "optim", "adam"),
            weight_decay=getattr(args, "weight_decay", 5e-4))
        self.step_fn = make_train_step(model, self.hp)

        now = [datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")]
        if self.mesh is not None:  # one run directory for every rank
            dist.broadcast_object_list(now, src=0)
        now = now[0]
        cfg = model.config
        tag = (f"{now}_{args.network}_L{cfg.n_layers}_{args.feature}"
               f"_B{args.batch_size}_K{getattr(args, 'max_keypoints', 0)}"
               f"_M{cfg.match_threshold}_{cfg.ac_fn}_{cfg.norm_fn}_{self.hp.optim}")
        self.save_dir = osp.join(args.save_path, tag)
        self.tag = tag
        self.writer = MetricWriter(self.save_dir) if self.is_main else _Silent()
        if self.is_main:
            with open(osp.join(self.save_dir, "args.json"), "w") as f:
                json.dump({k: str(v) for k, v in vars(args).items()}, f, indent=2)

        self.iteration = 0
        self.epoch = 0
        self.best_value = -np.inf

        # the preemption flag; the handler only sets it (a signal handler
        # may run between any two bytecodes of the training loop)
        self._preempted = False
        if threading.current_thread() is threading.main_thread():
            self._prev_sigterm = signal.signal(signal.SIGTERM, lambda *_: setattr(self, "_preempted", True))

    # ---------------------------------------------------------------- parallel
    def _setup_parallel(self, mp: int) -> None:
        """The mesh from the world, the groups handed to the model, the
        weights sliced under tensor parallelism (see the module docstring)."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world % mp:
            raise SystemExit(f"--model_parallel {mp} does not divide the {world} processes")
        self.mesh, self._control = None, None
        self.is_main = not dist.is_initialized() or dist.get_rank() == 0
        if not dist.is_initialized():
            return
        from impx_torch.parallel.mesh import make_mesh, set_data_group
        from impx_torch.parallel.tp import make_2d_mesh, shard_params_tp

        self.mesh = make_2d_mesh(world // mp, mp) if mp > 1 else make_mesh()
        if mp > 1:
            shard_params_tp(self.model, self.mesh)
        set_data_group(self.model, self.mesh.group("data"))
        if world > 1:  # host flags (SIGTERM) are agreed over gloo, off the card
            self._control = dist.new_group(backend="gloo")

    def _data_rows(self) -> tuple[int, int]:
        """(this rank's index on the data axis, the axis' size)."""
        if self.mesh is None:
            return 0, 1
        return self.mesh.index("data"), self.mesh.size("data")

    def _stop(self) -> bool:
        """The preemption flag, agreed between the ranks."""
        if self._control is None:
            return self._preempted
        flag = torch.tensor([int(self._preempted)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._control)
        return bool(flag.item())

    # ------------------------------------------------------------- checkpoints
    def save_checkpoint(self, opt_state: dict, name: str | None = None) -> str:
        """Every rank calls it (the tensor-parallel gather is a collective);
        rank 0 writes the full single-device layout."""
        from impx_torch.parallel.tp import gather_full

        name = name or f"{self.args.network}.{self.epoch:02d}"
        path = osp.abspath(osp.join(self.save_dir, name))
        params = gather_full(self.model, self.model.state_dict())
        opt = {"count": opt_state["count"], "mu": gather_full(self.model, opt_state["mu"]),
               "nu": gather_full(self.model, opt_state["nu"])}
        if self.is_main:
            torch.save({"params": params, "opt_state": opt,
                        "meta": {"epoch": self.epoch, "iteration": self.iteration,
                                 "best_value": self.best_value}}, path)
        return path

    def restore_checkpoint(self, path: str) -> dict:
        """Loads the parameters into the model; returns the optimizer state.
        Training resumes at the epoch after the saved one. The checkpoint's
        full layout is sliced for this rank under tensor parallelism."""
        ckpt = torch.load(path, map_location=self.model.device, weights_only=True)
        if getattr(self.model, "model_group", None) is not None:
            from impx_torch.tools.convert import tp_shard_state_dict

            rank, k = self.mesh.index("model"), self.mesh.size("model")
            cfg = self.model.config
            ckpt["params"] = tp_shard_state_dict(ckpt["params"], cfg, rank, k)
            for key in ("mu", "nu"):
                ckpt["opt_state"][key] = tp_shard_state_dict(ckpt["opt_state"][key], cfg, rank, k)
        self.model.load_state_dict(ckpt["params"])
        self.epoch = int(ckpt["meta"]["epoch"]) + 1
        self.iteration = int(ckpt["meta"]["iteration"])
        self.best_value = float(ckpt["meta"]["best_value"])
        return ckpt["opt_state"]

    # ------------------------------------------------------------------ epochs
    def _batches_sync(self) -> Iterable[dict]:
        """Global batches of args.batch_size samples in dataset order; this
        rank assembles its contiguous block of rows of each. A dataset whose
        samples draw from one stream (`draws_from_stream`: Megadepth's
        training) gives one process's rows only when drawn in order, so each
        rank then draws every row of the batch and keeps its own."""
        bs = self.args.batch_size
        n = len(self.dataset)
        d, n_data = self._data_rows()
        rows = bs // n_data
        every = n_data > 1 and getattr(self.dataset, "draws_from_stream", False)
        for idx in range(0, n - bs + 1, bs):
            if every:
                samples = [self.dataset[i] for i in range(idx, idx + bs)][d * rows:(d + 1) * rows]
            else:
                samples = [self.dataset[i] for i in range(idx + d * rows, idx + (d + 1) * rows)]
            yield {k: torch.from_numpy(np.stack([s[k] for s in samples]).astype(np.float32))
                   .to(self.model.device, non_blocking=True)
                   for k in samples[0] if isinstance(samples[0][k], np.ndarray)}

    def _batches(self) -> Iterable[dict]:
        """Batches assembled by a background thread, two ahead."""
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()

        def producer():
            try:
                for batch in self._batches_sync():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(sentinel)
            except BaseException as e:  # raised on the consumer side: a dead
                q.put(e)                # producer is not a clean end of epoch

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def process_epoch(self, opt_state: dict):
        """One epoch; returns (opt_state, mean loss of the good steps, or None
        when the epoch aborted). The host reads the device's running stats
        once per log interval, so the 10-in-a-row abort fires at the next log
        boundary; the consecutive-bad count carries across intervals."""
        its_per_epoch = getattr(self.args, "its_per_epoch", -1)
        log_intervals = getattr(self.args, "log_intervals", 50)
        device = self.model.device
        stats = init_stats(device)
        loss_sum, n_good = 0.0, 0.0
        metrics = None
        for bidx, batch in enumerate(self._batches()):
            if 0 <= its_per_epoch <= bidx or self._stop():
                break
            metrics, stats = self.step_fn(opt_state, self.iteration, batch, stats)
            self.iteration += 1
            if (bidx + 1) % log_intervals == 0:
                s = {k: float(v) for k, v in stats.items()}
                mean_loss = s["loss_sum"] / max(s["n_good"], 1.0)
                self.writer.text(
                    f"Epoch [{self.epoch}/{self.args.epochs}] Step [{bidx}/{self.iteration}] "
                    f"Loss [{mean_loss:.3f}] MS [{float(metrics['max_mscore']):.2f}] "
                    f"Acc [c{float(metrics['acc_corr']):.1f} n{float(metrics['acc_incorr']):.1f}] "
                    f"lr {float(metrics['lr']):.2e}")
                self.writer.write(self.iteration, {
                    "interval_mean_loss": mean_loss,
                    **{k: float(v) for k, v in metrics.items() if k != "bad_loss"}})
                if s["max_consec_bad"] >= 10:
                    self.writer.text("Abort epoch: >=10 consecutive INF/NAN losses")
                    return opt_state, None
                if s["max_consec_bad"] > 0:
                    self.writer.text(
                        f"Loss was INF/NAN on {log_intervals - int(s['n_good'])} steps this "
                        f"interval (max consecutive {int(s['max_consec_bad'])})")
                loss_sum += s["loss_sum"]
                n_good += s["n_good"]
                carry_bad = stats["consec_bad"]
                stats = init_stats(device)
                stats["consec_bad"] = carry_bad.clone()
                stats["max_consec_bad"] = carry_bad.clone()

        if metrics is not None:  # the tail since the last log boundary
            s = {k: float(v) for k, v in stats.items()}
            if s["max_consec_bad"] >= 10:
                self.writer.text("Abort epoch: >=10 consecutive INF/NAN losses")
                return opt_state, None
            loss_sum += s["loss_sum"]
            n_good += s["n_good"]
        return opt_state, (loss_sum / n_good if n_good else None)

    def train(self, opt_state: dict | None = None) -> dict:
        """Epochs until args.epochs; returns the optimizer state."""
        _, n_data = self._data_rows()
        if int(self.args.batch_size) % n_data:
            raise SystemExit(f"batch_size={self.args.batch_size} must be divisible by the data-parallel axis "
                             f"({n_data} ranks)")
        if opt_state is None:
            opt_state = init_opt_state(self.model)
        while self.epoch < self.args.epochs:
            t0 = time.time()
            opt_state, train_loss = self.process_epoch(opt_state)
            if self._stop():  # SIGTERM (on any rank): save mid-epoch and return
                path = self.save_checkpoint(opt_state, name=f"{self.tag}.preempt")
                self.writer.text(f"SIGTERM: preemption checkpoint -> {path}")
                return opt_state
            if train_loss is None:  # NaN abort: run the epoch again
                continue
            if self.eval_fn is not None and self.epoch % 5 == 0:
                eval_out = self.eval_fn(self.model)
                self.writer.write(self.iteration, eval_out, prefix="eval_")
                value = eval_out.get("prec", -train_loss)
            else:
                value = -train_loss
            path = self.save_checkpoint(opt_state)
            if value > self.best_value:
                self.best_value = value
                self.save_checkpoint(opt_state, name=f"{self.tag}.best")
            self.writer.text(f"Epoch {self.epoch}: loss {train_loss:.4f} value {value:.4f} "
                             f"({time.time() - t0:.1f}s) -> {path}")
            self.epoch += 1
            if hasattr(self.dataset, "build_dataset"):
                self.dataset.build_dataset(seed=self.epoch)
        return opt_state
