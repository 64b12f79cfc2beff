"""The matching loop: one caller matching batches of pairs, as an offline job
over a pair list does (impx_torch/eval/eval_imp.py's matcher call).

Set-up builds or loads the cell's kernels, makes the weights and a pool of
distinct batches on the device from the seed, and warms the cell's one
shape up. The window is a closed loop: each call is
`model.produce_matches(batch, p=threshold, only_last=True,
with_scores=False)`, and the next is issued once this one's indices0 and
mscores0 are on the host. Batches come from the pool in turn. A call's
latency runs from the call to its outputs on the host. A traced run makes
the traced calls after the window (benchlib/trace.py).

The check draws calls from the seed among those the window completed and
recomputes their matches with the plain reference (benchmark/reference/),
fp32 with TF32 off, and holds each number that the workload's file
limits (`compare` defines them) to its limit."""
from __future__ import annotations

import random
import statistics
import time

import torch

from benchlib import core
from benchlib.program import build_kernels, build_model
from benchlib.weights import make_weights
from reference import matcher as ref

WARMUP_CALLS = 2   # set-up's calls of the cell's one shape: the first builds, the second runs warm
PAIR_OFF = 1e-4    # a pair is off when its widest mscores0 gap exceeds this


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.matcher = cell.config["matcher"]
        self.eimp = cell.config["model"] == "AdaGMN"
        self.build_s = 0.0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        cell, dev = self.cell, self.device
        self.build_s = build_kernels(cell.workload["kernels"], dev)
        gen = lambda tag: torch.Generator(device=dev).manual_seed(core.seed_for(self.seed, tag))  # noqa: E731
        self.weights = make_weights(cell.config, gen("weights"), dev)
        self.model = build_model(cell.config, self.weights, dev)
        traffic = core.generator_module(cell.traffic)
        self.pool = traffic.make_pool(cell.traffic, self.matcher["descriptor_dim"], gen("traffic"), dev)
        self.counts = [(b["valid0"].sum(1).tolist(), b["valid1"].sum(1).tolist()) for b in self.pool]
        self.outputs = []                                  # per window call: (call index, outputs)
        self.next = 0
        for _ in range(WARMUP_CALLS):
            self.call(self.next)
            self.next += 1

    def forward(self, batch: dict) -> dict:
        return self.model.produce_matches(batch, p=self.matcher["match_threshold"], only_last=True,
                                          with_scores=False)

    def to_host(self, out: dict) -> dict:
        """A call's matches on the host."""
        host = {"indices0": out["indices0"][-1].cpu(), "mscores0": out["mscores0"][-1].cpu()}
        if self.eimp:   # kept on the device: the check reads them, the caller's loop does not
            host.update({k: out[k] for k in ("keep0", "keep1", "overflow0", "overflow1")})
        return host

    def call(self, i: int) -> dict:
        """Call i on pool batch i mod pool; its outputs on the host."""
        return self.to_host(self.forward(self.pool[i % len(self.pool)]))

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer=None) -> dict:
        lat, calls, failed = [], 0, 0
        b = self.cell.traffic["pairs"]
        t0 = time.perf_counter()
        while True:
            i = self.next + calls
            ts = time.perf_counter()
            out = self.call(i)
            te = time.perf_counter()
            lat.append(1e3 * (te - ts))
            if not bool(torch.isfinite(out["mscores0"]).all()):
                failed += 1
            self.outputs.append((i, out))
            calls += 1
            if te - t0 >= seconds:
                break
        window_s = te - t0
        pairs_per_s = b * calls / window_s
        core.log(f"window {window_s:.6f} s, {calls} calls of {b} pairs, median call "
                 f"{sorted(lat)[len(lat) // 2]:.4f} ms, p95 {core.p95(lat) if calls > 1 else lat[0]:.4f} ms, "
                 f"max {max(lat):.4f} ms")
        counts = [self.counts[(self.next + c) % len(self.pool)] for c in range(calls)]
        if tracer is not None:
            first = self.next + calls
            self.traced = [self.counts[(first + k) % len(self.pool)] for k in range(tracer.count)]
            self.outputs += list(enumerate(tracer.run(self.call, first), start=first))
        if self.eimp:
            over = [int(o["overflow0"].sum()) + int(o["overflow1"].sum()) for _, o in self.outputs[-len(self.pool):]]
            core.log(f"eimp: overflowed survivors a call over the last {len(over)} calls: {over}")
        return {"metrics": {"pairs_per_s": pairs_per_s, "match_ms_p95": core.p95(lat) if calls > 1 else lat[0]},
                "attempted": calls, "failed": failed, "seconds": window_s, "counts": counts}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def sample(self) -> list:
        """Calls of distinct pool batches, drawn from the seed."""
        by_batch = {}
        for i, out in self.outputs:
            by_batch[i % len(self.pool)] = (i, out)
        picks = sorted(by_batch)
        random.Random(core.seed_for(self.seed, "sample")).shuffle(picks)
        return [by_batch[k] for k in picks[: self.cell.workload["check"]["calls"]]]

    def reference(self, batch: dict, bits: int = 23) -> dict:
        P = ref.Plain(bits)
        with ref.plain_fp32():
            with torch.no_grad():
                if self.eimp:
                    return ref.eimp_matches(P, self.weights, self.matcher, batch)
                return ref.imp_matches(P, self.weights, self.matcher, batch)

    def compare(self, pairs: list) -> dict:
        """The numbers compared, over (batch, program outputs, reference
        outputs) triples: idx_mismatch, the share of valid rows whose
        indices0 differ; mscore_gap, the widest and mscore_rms, the root
        mean square gap of mscores0 over the rows both sides match to the
        same keypoint, and mscore_rms_median_pair, that root mean square
        of the median pair; pairs_off_share, the share of pairs whose widest
        gap there exceeds PAIR_OFF; keep_mismatch (EIMP), the share of valid keypoints whose final keep
        differs."""
        rows = mism = keeps = kmism = pairs_off = 0
        gaps, pair_rms = [], []
        for batch, out, want in pairs:
            valid = batch["valid0"].cpu()
            idx, ridx = out["indices0"].cpu(), want["indices0"].cpu()
            same = idx == ridx
            rows += int(valid.sum())
            mism += int((~same & valid).sum())
            both = same & (idx >= 0) & valid
            d = (out["mscores0"].cpu() - want["mscores0"].cpu()).abs()
            gaps.append(d[both])
            pairs_off += int((torch.where(both, d, 0.0).amax(1) > PAIR_OFF).sum())
            for row, used in zip(d, both):
                pair_rms.append(float(row[used].double().square().mean().sqrt()) if bool(used.any()) else 0.0)
            if self.eimp:
                for k in (0, 1):
                    v = batch[f"valid{k}"].cpu()
                    keeps += int(v.sum())
                    kmism += int(((out[f"keep{k}"].cpu() != want[f"keep{k}"].cpu()) & v).sum())
        gaps = torch.cat(gaps).double() if gaps else torch.zeros(0, dtype=torch.float64)
        numbers = {"idx_mismatch": mism / max(rows, 1),
                   "mscore_gap": float(gaps.max()) if len(gaps) else 0.0,
                   "mscore_rms": float(gaps.square().mean().sqrt()) if len(gaps) else 0.0,
                   "mscore_rms_median_pair": statistics.median(pair_rms) if pair_rms else 0.0,
                   "pairs_off_share": pairs_off / max(len(pair_rms), 1)}
        if self.eimp:
            numbers["keep_mismatch"] = kmism / max(keeps, 1)
        return numbers

    def check(self, pairs: list | None = None) -> tuple[bool, list]:
        if pairs is None:
            pairs = [(self.pool[i % len(self.pool)], out, self.reference(self.pool[i % len(self.pool)]))
                     for i, out in self.sample()]
        numbers = self.compare(pairs)
        for batch, out, want in pairs:
            if self.eimp:
                core.log(f"check: program overflow {out['overflow0'].tolist()} / {out['overflow1'].tolist()}, "
                         f"reference {want['overflow0'].tolist()} / {want['overflow1'].tolist()}; kept "
                         f"{out['keep0'].sum(1).tolist()} (reference {want['keep0'].sum(1).tolist()})")
            core.log(f"check: matches {(out['indices0'] >= 0).sum(1).tolist()} (reference "
                     f"{(want['indices0'] >= 0).sum(1).tolist()}) of valid {batch['valid0'].sum(1).tolist()}")
        limits = self.cell.workload["check"]["limits"]
        listed = [(name, numbers[name], limits[name]) for name in limits]
        correct = bool(pairs) and all(v <= lim for _, v, lim in listed)
        return correct, listed
