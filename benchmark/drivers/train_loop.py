"""The training loop: `make_train_step`'s step (the training CLI's
Trainer.step_fn) over batches drawn on the device, one step after another.

Set-up builds or loads the cell's kernels, makes the weights and a pool of
distinct batches on the device from the seed, builds the model, Adam's
state and the step, and drives that same step through its first three
steps on pool batches 0, 1, 2: the loss of each, the first gradient as Adam
holds it (its first moment over 1 - b1) and the parameters after the third
are kept for the check. The window then continues the same object over the
pool in turn; each step ends with its loss on the host, as a trainer that
logs it. A traced run makes the traced steps after the window
(benchlib/trace.py).

The check runs the plain reference (benchmark/reference/) from the same
weights over the same three batches, fp32 with TF32 off, and compares each
step's loss, each leaf's first-gradient norm and each leaf's change after
three steps, by the worst leaf: the gap of the two norms over the larger of
the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is below a thousandth of the median leaf's (the biases
that InstanceNorm or the softmax cancel) move by round-off alone and are
left out of the change."""
from __future__ import annotations

import statistics
import time

import torch

from benchlib import core
from benchlib.weights import make_weights
from benchlib.program import build_kernels, build_model
from reference import matcher as ref

REF_STEPS = 3
NOUGHT = 1e-3      # a leaf whose reference gradient norm is under this share of the median leaf's


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.matcher = cell.config["matcher"]
        self.build_s = 0.0

    def setup(self) -> None:
        from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

        cell, dev = self.cell, self.device
        self.build_s = build_kernels(cell.workload["kernels"], dev)
        gen = lambda tag: torch.Generator(device=dev).manual_seed(core.seed_for(self.seed, tag))  # noqa: E731
        self.weights = make_weights(cell.config, gen("weights"), dev)
        self.model = build_model(cell.config, self.weights, dev)
        traffic = core.generator_module(cell.traffic)
        self.pool = traffic.make_pool(cell.traffic, self.matcher["descriptor_dim"], gen("traffic"), dev)
        self.counts = [(b["valid0"].sum(1).tolist(), b["valid1"].sum(1).tolist()) for b in self.pool]
        if len(self.pool) <= REF_STEPS:
            raise ValueError("the training pool needs more batches than the steps the check follows")
        train = cell.config["train"]
        self.lr = train["lr"]
        self.opt = init_opt_state(self.model)
        self.stats = init_stats(dev)
        self.step = make_train_step(self.model, TrainHyperParams(lr=train["lr"], optim=train["optim"]))
        self.losses, self.first_grad = [], None
        for i in range(REF_STEPS):
            self.call(i)
            if i == 0:
                self.first_grad = {n: m / (1 - ref.ADAM_B1) for n, m in self.opt["mu"].items()}
        self.after = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.next = REF_STEPS

    def call(self, i: int) -> float:
        metrics, self.stats = self.step(self.opt, i, self.pool[i % len(self.pool)], self.stats)
        loss = metrics["loss"].item()
        if i < REF_STEPS:
            self.losses.append(loss)
        return loss

    def window(self, seconds: float, tracer=None) -> dict:
        lat, steps, failed = [], 0, 0
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            loss = self.call(self.next + steps)
            te = time.perf_counter()
            lat.append(1e3 * (te - ts))
            failed += not (loss == loss and abs(loss) != float("inf"))
            steps += 1
            if te - t0 >= seconds:
                break
        window_s = te - t0
        b = self.cell.traffic["pairs"]
        core.log(f"window {window_s:.6f} s, {steps} steps of {b} pairs, median step "
                 f"{statistics.median(lat):.4f} ms, max {max(lat):.4f} ms; losses of the first steps {self.losses}")
        counts = [self.counts[(self.next + c) % len(self.pool)] for c in range(steps)]
        if tracer is not None:
            first = self.next + steps
            self.traced = [self.counts[(first + k) % len(self.pool)] for k in range(tracer.count)]
            tracer.run(self.call, first)
        return {"metrics": {"train_pairs_per_s": b * steps / window_s}, "attempted": steps, "failed": failed,
                "seconds": window_s, "counts": counts}

    def release(self) -> None:
        del self.model, self.opt, self.step
        self.pool = self.pool[:REF_STEPS]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference(self, bits: int = 23) -> dict:
        with ref.plain_fp32():
            return ref.adam_steps(ref.Plain(bits), self.weights, self.matcher, self.pool[:REF_STEPS], self.lr)

    def compare(self, losses: list, first_grad: dict, after: dict, want: dict) -> dict:
        """The numbers compared: the worst step's relative loss gap, and the
        worst leaf's gap of first-gradient and change norms."""
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, want["losses"]))
        gref = {n: float(torch.linalg.vector_norm(g)) for n, g in want["first_grad"].items()}
        gmed = statistics.median(gref.values())
        grad_gap = max(abs(float(torch.linalg.vector_norm(first_grad[n])) - gref[n]) / max(gref[n], gmed)
                       for n in gref)
        moved = [n for n in gref if gref[n] >= NOUGHT * gmed]
        dref = {n: float(torch.linalg.vector_norm(want["params"][n] - self.weights[n])) for n in moved}
        dmed = statistics.median(dref.values())
        change_gap = max(abs(float(torch.linalg.vector_norm(after[n] - self.weights[n])) - dref[n]) / max(dref[n], dmed)
                         for n in moved)
        left_out = sorted(set(gref) - set(moved))
        core.log(f"check: reference losses {want['losses']}, program {losses}; {len(left_out)} leaves with a "
                 f"nought reference gradient left out of the change: {left_out}")
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}

    def check(self, program: tuple | None = None, want: dict | None = None) -> tuple[bool, list]:
        want = want or self.reference()
        losses, first_grad, after = program or (self.losses, self.first_grad, self.after)
        numbers = self.compare(losses, first_grad, after, want)
        limits = self.cell.workload["check"]["limits"]
        listed = [(name, numbers[name], limits[name]) for name in limits]
        return all(v <= lim for _, v, lim in listed), listed
