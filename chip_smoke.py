"""Drive impx_torch's main path on one CUDA card and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Phases: (1) the card, versions and TF32 flags; (2) build the CUDA kernels from
impx_torch/csrc, with ptxas's registers and spills for each kernel, and a
summary line (registers, spills, shared memory) for each instantiation of the
bf16 attention forward, of the fp32 kernels in 3xTF32 (the forward
attn_fwd_tf32x3<dh, 1>, its row lse alone <dh, 0>, the mass
key_mass_tf32x3<dh>), and of the persistent Sinkhorn kernels, and every
wgmma kernel's machine code read for register faults
(impx_torch/tools/sass_check.py); (3) each kernel
against its plain PyTorch version at the main path's shapes (kernel 1 at bf16
and fp32 and kernel 4 at fp32, o and lse, twice for the same bits, also with
fewer keys than queries, [8, 4, 2048, 64] against 1536 keys and a ragged
333 x 290; the
attention-mass and Sinkhorn kernels also twice on the same inputs, for the
same bits, and once more through a CUDA-graph replay; the attention mass on
both routes, from kernel 4's row lse and from its own, at the main path's
shape in bf16 and fp32, EIMP's compacted sizes and a ragged shape with a
fully masked batch, with its device launches a call; the MLP block's norm
(kernel 8, csrc/norm.cu) at the layers' [2B, N, 2D] and the encoder's
[B, N, 32-256] in fp32 and bf16 and at an image whose rows exceed a CTA's
shared memory, twice for the same bits); (4)
DGNNS.produce_matches at the published eval config (15 layers, D = 256, 2048
keypoints, 4 pairs, bf16) with random weights from a seed carried through the
reference-checkpoint loader, counting kernel launches (the norm kernel's 38
too, here and in phase 7) and comparing with the
plain path; (5) CUDA-event timings of each kernel, its plain version and the
library call, and of the whole call, the host time of one attention
wrapper call (median over WRAPPER_CALLS calls, host clock), kernels 1
and 4 (phase 9) beside sdpa and kernels 2 and 7 (phase 13) with 20 calls
queued back to back, and the Sinkhorn kernels' schedule (CTAs, rows kept on
chip, overflow bytes); kernels 1 and 4 at fp32, one call and 20 queued,
beside their 3xTF32 and FMA bounds, the plain version and sdpa at fp32 (its
backend named); (6) a torch.profiler breakdown of the main path's
device time by kernel and the device's idle share, with the attention group
beside its time before the bf16 forward's redesign, and in this and every
later profile the device launches of each kernel wrapper call (at most 3 for
kernels 2 and 7); (7) AdaGMN (EIMP) at the same config, mask-only
and bucket-compacted, on pairs that overlap in part: launches per call (a
pooling iteration's two layers run kernel 4, whose row lse the masses take),
the keep counts after each pool, overflow, and agreement with the plain path;
(8) the attention mass's times on both routes (one call, queued, and a CUDA
graph's device time), its bound and its split at the compacted sizes, its
fp32 times on both routes beside the 3xTF32 and FMA bounds,
pairs_per_s of both EIMP variants, kernel and plain path, and the profile of
each (device time by kernel, host time by operation, the attention-mass group
beside its time before the redesign), and the norm kernel against the
eager chain it replaces at the benchmark's layer shapes in fp32 and at the
main path's in bf16 (one call, queued, in a CUDA graph, the bound of its
bytes, the host time of a call through its op); (9) the
training kernels, the forward that writes the row log-sum-exp (kernel 4)
and the two attention backwards (kernels 3 and 5),
against their plain versions at the training shape [32, 4, 1024, 64] in bf16
and fp32, and at a ragged fp32 shape at dh = 32 and one at dh = 16 (the
backwards twice, for the same bits; the fully masked batch on a line of its
own), with their times, bounds, plain and library times; (10) one DGNNS training step at the
published training config (configs/config_train_megadepth.json: 15 layers, D =
256, 1024 keypoints, 16 pairs, bf16, a loss on every iteration), route A and
route B, on the kernel path and on the plain path on the same batch and
weights: launches a step, the plain bodies never called on the kernel path,
the loss's relative difference and the smallest gradient cosine over the
parameter leaves; (11) make_train_step over fresh batches, each route: train
pairs/s, peak device memory and a profile of one step, in which the route's
attention backward takes two device launches a call (a dq launch and a dk/dv
launch); (12) steps on one fixed batch, each route: the loss falls and the NaN
guard skips no step; then phases 10 and 11 again at fp32 (the training CLI's
default compute dtype; fewer timed steps, no fixed-batch loop), the loss and
gradients held ten times tighter than at bf16, and kernels 3 and 5 at fp32
timed at the training shape, one call and 20 queued, beside their 3xTF32 and
FMA bounds, the plain version, sdpa's fp32 backward (its backend named) and
the FMA design's time before their 3xTF32 redesign; (13) the log-Sinkhorn kernel (kernel 7) against its plain
version at dist [4, 2048, 2048] (bf16 Z) at 20 and 100 iterations, at a
ragged fp32-Z shape and at [4, 2048, 1536] (SuperGlue's plan at N0 != N1) at
100 iterations, twice for the same bits and through a CUDA-graph replay,
with its times, bound, plain time and schedule; (14) DGNNS under the log-domain head (eval_config('spp', 15), log_ot,
bf16, 4 pairs of 2048 keypoints): launches per call, agreement with the plain
path, pairs_per_s and a profile; (15) SuperGlue at its published configuration
(9 layers, D = 256, 100 Sinkhorn iterations, batch norm from random running
statistics, weights carried through the reference SuperGlue layout), the same
checks; (16) the eval CLI's loop, impx_torch.eval.eval_imp.evaluate, at the
YFCC eval config (16 synthetic pairs of 2000 keypoints, bucket 2048, batch 4,
15 layers, D = 256, random weights carried through the reference layout, the
on-device pose backend): the backend's pose recovery on each pair's true
correspondences with 30% outliers; IMP at fp32 (the CLI's default) and bf16
on the kernel and the plain path (launches per batch, indices0 agreement,
equal pose errors on equal match sets) and EIMP mask-only at bf16;
pairs_per_s of the loop and its split (matcher, device pose, host metrics),
a profiled batch of the pose stage and of the fp32 matcher with kernel 1's
fp32 and kernel 2's time a launch beside their bounds and the matcher's
device time, each beside its time before the 3xTF32 redesign; (17) the iterative
match-pose loop with early stopping through evaluate --use_iterative at the
same config and pairs (five-point checkpoint solver, 4096 minimal sets a
checkpoint): the checkpoint solver's pose recovery on true correspondences
with 30% outliers; IMP fp32 pair by pair (IterativeMatcher.run), IMP fp32
and bf16 in batches of 4 (BatchedIterativeMatcher.run_batch), EIMP with
uncertainty pooling (kernel 4's row lse to kernel 6) and the cv2 checkpoints,
each on the kernel and the plain path: launches against the layer steps each
loop ran, no plain body on the kernel path, no synchronising operation
inside a checkpoint, indices0 agreement at every checkpoint, equal poses from
equal compacted sets, serial against batched, early exit at
pose_stop_deg=180 launching kernel 1 only for the layers run, the checkpoint
solve's device operations at 1 and 4 pairs, the split of a checkpoint's
time, and profiled kernel 1 and kernel 6 times a launch at fp32 (kernel 6
beside its time before the 3xTF32 redesign); (18) the remaining inference
routes at full width (eval_config('spp', 15), D = 256, 4 pairs; random
weights and batch-norm statistics carried through the reference layout),
each on the kernel and the plain path with its launches per kernel, no
kernel's plain version called on the kernel path, indices0 agreement (and
keep agreement for EIMP), the kernel path's pairs_per_s and a profile: (a) IMP with the
dual-softmax head (kernel 2 off the path), (b) EIMP mask-only with it, (c)
DGNNS with batch norm at 2048 = 2048 and 2048 / 1536, (d) EIMP's masked loop
at 2048 / 1536, (e) the masked loop under log_ot (kernel 7 every iteration,
the keep counts after each pool, which must fall), (f) SuperGlue at 2048 /
1536, (g) FMBenchEval's device F backend against cv2 on 16 synthetic pairs
(precision after RANSAC, SGD, ms a pair); (19) from images to matches:
SuperPoint at fp32 (cuDNN's TF32 off) on the card against the CPU at
[1, 120, 160] (dense maps at rtol 1e-4 / atol 1e-5, keypoints by impx's
margin rule) and bf16 against fp32 at 480 x 640 (overlap 0.85), SuperPoint's
ms an image at bench_suite.py's 480 x 640 (B = 4, K = 1024, bf16 and fp32)
and 1200 x 1600 (B = 2, K = 2048, bf16), its stages, the top-k on 1.92 M
pixels and a profile by group (convolutions, pools and NMS, sort/top-k,
descriptor sampling, other); the ScanNet protocol end to end (4 pairs of
480 x 640 images, bf16 SuperPoint at 1024 keypoints, IMP bf16: 30 + 1
launches, no plain body, indices0 agreement with the plain matcher path,
pairs_per_s, SuperPoint's share, a profile); the demo CLI on two PNGs with
--fx (SuperPoint, SIFT at D = 128, EIMP: PNG written, launches, host
seconds); match_from_projection_points at 4096 keypoints a side against the
CPU (equal labels, ms); (20) the queue loops (impx_torch/eval/iterative_{fused,
refill,staged}.py) on one queue of 64 pairs of 2048 keypoints from
synthesize_feed_device (matchable pairs and pairs with no true
correspondence alternating), eval_config('spp', 15) at bf16, 16 pairs in
flight: the lockstep loop in 4 batches (also with uncertainty pooling on
AdaGMN), slot refill at 16 slots, staged cohorts of 16, and
BatchedIterativeMatcher for scale, each with its pairs/s (host clock), stop
histogram, steps, checkpoints, host reads and launches of kernels 1, 2 and
6, and a device-only profile (busy, idle share, operations); checks (a)
varied stops, (b) every pair completed, (c) refill and staged on the
permuted queue give every pair the same stop, (d) each loop at fp32 on 16
pairs on the kernel path (no plain body) against the plain path; (21) the
training CLI: kernels 3, 4 and 5 at Nq != Nk, step checks of GM's unrolled
training and of DGNNS under the log-OT head and the dual softmax, and the
CLI in process on --synthetic at the published training config, 6 steps a
run (step ms, train and loop pairs/s, peak memory, idle share of a profiled
step); (22) EIMP training and batch norm in train mode at the published
training config, fp32: one step, kernel path against plain path, of
AdaGMN's masked and compacted ((4, 512), (8, 256)) training scans (kernels
1 and 3 30 launches each, kernel 6 12 calls on its standalone route), DGNNS
and AdaGMN under batch norm, and SuperGlue at its published widths (kernel
7 9 launches), loss within 1e-4, cosines above 0.9999, the keep counts of
every pool; AdaGMN's masked and compacted make_train_step in turns (step
ms, a profiled step's device time, idle share and operations); then the
CLI's --network adagmn, --train_compaction 4:512,8:256, --norm_fn bn and
--network adagmn --norm_fn bn runs as in (21). (23) Parallelism: (a) the
data-parallel step through a one-rank NCCL group against the plain step,
fp32 and bf16, its all-reduces counted; then ranks sharing the one card over
gloo (`--parallel-rank`): (b) the data-parallel step at world 2 and (c) the
tensor-parallel forward, AdaGMN's pooling and step at (1, 2), the steps held
by their loss and the gradient each applied (cosines, global norm) against
the one-process step's; (d) the GPipe forward at 3 stages x 2 microbatches
against forward_scan. (24) Kernels 1, 4, 3 and 5 at fp32 at [4, 4, 2048,
64] and [2, 4, 4096, 64] (one batch of valid keys), each tile's P.V, dQ, dK
and dV taken from zero and added in fp32: held against their plain versions
(FWD_O_REL_L2, TRAIN_REL_L2, the backwards' same bits twice) and read
against float64, a reading at 4096 keys over FP64_GROWTH_MAX times the one
at 2048 failing; (a) sequence parallelism
(impx_torch/parallel/tp.py:shard_batch_sp, mesh.set_seq_group) through a
one-rank NCCL group in process and over 2 ranks sharing the card through
gloo: IMP bf16 at the eval config (indices0 against one process), AdaGMN
mask-only (keep counts), the training config's fp32 step (loss, gradient
cosines and global norm); (b) the serving export (impx_torch/tools/
export.py) of IMP and EIMP mask-only at the eval config on the card and of a
3-layer program exported on the CPU and moved to cuda: the exported call's
launches and outputs against the eager call's; the host µs of a kernel-1
call through its torch.library op against the direct launch; (c) a
torch.profiler trace (impx_torch/tools/profiling.py) that must name
attn_fwd_wgmma; (d) pose_study, fm_study and geo_study at --fast, timed.
The line
before the last lists the kernels as JSON (with each kernel's launches over
phase 17's, 18's, 19's, 20's, 21's and 22's kernel-path runs, phase 23's as
"launches_parallel", phase 24's as "launches_sp_export", and for kernels 1, 3, 4, 5 and 6 an "fp32" entry:
times, both bounds, the plain and library times); the last line is
{"ok": true, "device": {...}}. Any failure exits nonzero. Needs one CUDA
device; exits nonzero without one.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): bf16 and TF32 tensor cores, fp32 outside them, HBM
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_EXP_PER_S = 132 * 16 * 1.98e9   # MUFU: 16 per SM per clock, 132 SMs, 1.98 GHz boost

B, N, D, H = 4, 2048, 256, 4      # the main path: 4 pairs of 2048 keypoints
ITERS = 20
TIMED_RUNS = 6                    # 12 before phase 18, 8 before phase 23: the script stays within about 600 s
WRAPPER_CALLS = 300               # host-clock calls of the attention wrapper, already-built inputs
# the main path's attention group in the profile before the bf16 forward's
# redesign (mma.sync, 64-query blocks), as PERF.md section 5 records it
ATTN_GROUP_MS_BEFORE = 7.996
# EIMP's attention-mass group before the mass kernel's one-pass redesign
# (two passes, a second launch a call), as PERF.md section 5 records it
MASS_GROUP_MS_BEFORE = {"mask-only": 3.964, "compacted": 1.228}
# the fp32 instantiations before their 3xTF32 redesign (FMA designs), as
# PERF.md sections 5 and 6 record them: kernel 1 a launch and the eval fp32
# matcher's device time a call (phase 16), kernel 6 a launch (phase 17)
F32_ATTN_MS_BEFORE = 2.5575
F32_MATCHER_MS_BEFORE = 103.5
F32_MASS_MS_BEFORE = 1.395
# kernels 3 and 5 at fp32 before their 3xTF32 redesign (the FMA design),
# 20 calls queued at [32, 4, 1024, 64], as PERF.md section 6 records them
F32_BWD_MS_BEFORE = {"mha_bwd": 15.1374, "mha_bwd_from_lse": 10.1832}
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # atol = rtol, vs plain
SINK_RTOL, SINK_ATOL, IDX_FLIP_MAX = 1e-3, 1e-6, 1e-3
E2E_AGREE_MIN = 0.95              # indices0 equal, kernel vs plain path (bf16)
MASS_RTOL, MASS_ATOL = 1e-4, 1e-6  # mass kernel vs plain: summation order only
# EIMP: bench.py:186-188's schedule; a dustbin score that sends the unmatched
# rows' plan mass to the dustbin, so that random weights leave pooling
# something to drop (at the initial 1.0 every row keeps mass >= mscore_th)
EIMP_COMPACTION = ((4, 1024), (8, 512), (12, 256))
EIMP_BIN_SCORE = 9.0
EIMP_KEEP_AGREE_MIN = 0.99        # final keep masks equal, kernel vs plain path
# training: configs/config_train_megadepth.json (batch 16, 1024 keypoints)
TB, TN = 16, 1024
TRAIN_STEPS = 4                   # timed make_train_step steps a route, fresh batches (10 before phase 18, 6 before 23)
FIXED_STEPS = 6                   # steps on one fixed batch a route: the loss must fall (10 before phase 23)
TRAIN_STEPS_F32 = 3               # the same at fp32 (no fixed-batch loop: the bf16 routes hold it)
FWD_LSE_TOL = 1e-5                # the row log-sum-exp, fp32, elementwise (atol = rtol)
# the training kernels' dq, dk and dv against their plain versions: the
# relative L2 error of each batch's [H, N, dh] slice. fp32: sums in another
# order. bf16: both sides round the outputs once (2^-8 relative), and kernel 5
# also rounds p and ds, so an fp32 difference flips a rounding now and then.
# A kernel 5 that dropped delta moves dq by 0.14 and dk by 0.056 (the plain
# versions at [2, 4, 1024, 64]). Relative to each batch's own norm, the fully
# masked batch (kernel 5's p = 1 on every key, outputs about Nk times larger)
# is held to the same limit and printed on its own line.
TRAIN_REL_L2 = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# kernel 4's o: the online softmax rounds each tile's exp(s - running max) to
# bf16 before P.V, the plain version exp(s - row max), so every term carries
# its own rounding (2^-9 relative rms): about 2e-3 at bf16
FWD_O_REL_L2 = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# loss and each gradient leaf, kernel path vs plain path: bf16, and fp32 ten
# times tighter (the fp32 kernels are within 1e-5 of their plain versions)
TRAIN_LOSS_RTOL = {"bfloat16": 1e-2, "float32": 1e-3}
GRAD_COS_MIN = {"bfloat16": 0.99, "float32": 0.999}
# the log-Sinkhorn kernel vs its plain version: both round Z alike, so the
# summation order only; u and v at invalid entries hold about 2.56e26 under
# the bf16 Z rule, where one fp32 ulp is 7.6e22
LOG_ITERS = (20, 100)             # DGNNS log_ot (the eval config's) and SuperGlue's published count
LOG_RTOL, LOG_ATOL, LOG_INVALID_ATOL = 1e-4, 1e-5, 1e23
# SuperGlue's published configuration (magicleap/SuperGluePretrainedNetwork,
# models/superglue.py default_config): descriptor 256, encoder (32, 64, 128,
# 256), 4 heads, 9 x (self, cross), 100 Sinkhorn iterations, threshold 0.2
SG_LAYERS, SG_ITERS = 9, 100
# descriptors twice the unit-variance scale: at 1x random SuperGlue weights
# leave most true matches under the 0.2 threshold (tests/test_torch_logot.py)
SG_DESC_SCALE = 2.0
PLAIN_BODIES = ("mha_reference", "mha_lse_reference", "mha_bwd_reference", "mha_bwd_from_lse_reference")
# phase 18: image 1's keypoints on the routes at N0 != N1 (image 0 keeps N)
ROUTE_N1 = 1536


def say(*parts):
    print(*parts, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, inputs, warmup: int = 2) -> float:
    """Median CUDA-event time of fn(*x), x cycling over `inputs` (fresh data
    each run), after warm-up."""
    for x in inputs[:warmup]:
        fn(*x)
    times = []
    for i in range(TIMED_RUNS):
        x = inputs[i % len(inputs)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, inputs, calls: int = 20) -> float:
    """Median device ms a call over TIMED_RUNS windows of `calls` calls queued
    back to back between two events. The host enqueues the next call while
    the device runs the last, so a short kernel's time is not padded by its
    wrapper's host time, as one call between events (cuda_ms) is when the
    device waits for the launch."""
    for x in inputs[:2]:
        fn(*x)
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, inputs, calls: int = 20) -> float:
    """Median device ms a call over TIMED_RUNS replays of one CUDA graph that
    holds `calls` calls (inputs cycled): the device time without any host
    time, for kernels shorter than their wrapper's host time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:
            fn(*x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def padded_counts(gen, batch: int, n: int, low: int) -> torch.Tensor:
    return torch.randint(low, n + 1, (batch,), generator=gen)


# ---------------------------------------------------------------- attention
def attention_inputs(gen, dev, dtype, b=2 * B, h=H, n=N, dh=D // H, fully_masked=False, nk=None):
    """q [b, h, n, dh], k and v with nk keys (n by default), and a padded key
    mask (up to 300 padded keys: at small sizes a batch may have none valid)."""
    nk = n if nk is None else nk
    q = torch.randn((b, h, n, dh), generator=gen).to(dev, dtype)
    k, v = (torch.randn((b, h, nk, dh), generator=gen).to(dev, dtype) for _ in range(2))
    counts = padded_counts(gen, b, nk, nk - 300)
    mask = torch.arange(nk)[None] < counts[:, None]
    if fully_masked:
        mask[-1] = False
    return q, k, v, mask.to(dev)


def bound(flops: float, peak: float, nbytes: float) -> tuple[float, str, float]:
    """(least ms, 'operations' or 'bytes', ms of the bytes alone): the larger
    of flops at the peak rate and bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), 1e3 * t_bytes


def fp32_bounds(flops: float, exps: float, nbytes: float) -> dict:
    """The least times of fp32-exact work, each against the bytes at the HBM
    rate: "fma", the products in one fp32 pass on the FMA pipes; "tf32x3",
    three TF32 passes on the tensor cores beside the exponentials at the
    special-function rate. Values (ms, 'operations' or 'bytes')."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = {}
    for name, t_ops in (("fma", flops / PEAK_FP32), ("tf32x3", max(3 * flops / PEAK_TF32, exps / SFU_EXP_PER_S))):
        out[name] = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def bounds_text(b: dict) -> str:
    return (f"bound 3xTF32 {b['tf32x3'][0]:.4f} ms ({b['tf32x3'][1]}), FMA {b['fma'][0]:.4f} ms "
            f"({b['fma'][1]})")


def attention_work(q, mask) -> tuple[float, float, float]:
    """This call's work with valid keys only: (QK^T and P.V flops, one
    exponential a (query, valid key) pair, the bytes of q, o and the valid
    k, v rows and the mask)."""
    b, h, nq, dh = q.shape
    valid_keys = int(mask.sum().item())
    nbytes = q.element_size() * (2 * b * h * nq * dh + 2 * h * dh * valid_keys) + mask.element_size() * mask.numel()
    return 4.0 * h * nq * dh * valid_keys, float(h * nq * valid_keys), nbytes


def attention_bound(q, mask) -> tuple[float, str, float]:
    """(least ms, what bounds it, ms of the bytes alone) of kernels 1 and 4 at
    bf16: the products at the bf16 tensor-core rate (fp32: fp32_bounds)."""
    flops, _, nbytes = attention_work(q, mask)
    return bound(flops, PEAK_BF16, nbytes)


# kernel 1 and 4's shapes in phase 3: the main path's, a ragged one, and both
# with fewer keys than queries (the cross layers of a pair with 2048 and 1536
# keypoints, and a ragged Nq != Nk)
ATTN_CHECK_SHAPES = (dict(), dict(b=3, h=2, n=333, dh=32), dict(nk=ROUTE_N1),
                     dict(b=3, h=2, n=333, nk=290, dh=32))


def check_attention(dev, ka) -> dict:
    """Kernel 1 (bf16 and fp32) and kernel 4 at fp32 against their plain
    versions at ATTN_CHECK_SHAPES, the last batch fully masked: o within
    ATTN_TOL, kernel 4's lse within FWD_LSE_TOL and -1e30 exactly on the
    fully masked batch; each twice for the same bits. Prints every check
    before failing on any. Returns the largest error at the main shape by
    (kernel, dtype)."""
    gen = torch.Generator().manual_seed(1)
    errs, failures = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ATTN_CHECK_SHAPES:
            q, k, v, mask = attention_inputs(gen, dev, dtype, fully_masked=True, **shape)
            runs = {"mha_fused": [(ka.mha_fused(q, k, v, mask), None) for _ in range(2)]}
            if dtype == torch.float32:
                runs["mha_fused_lse"] = [ka.mha_fused_lse(q, k, v, mask) for _ in range(2)]
            torch.cuda.synchronize()
            ref, ref_lse = ka.mha_lse_reference(q, k, v, mask)
            for name, ((out, lse), (out2, lse2)) in runs.items():
                err = (out.float() - ref.float()).abs()
                tol = ATTN_TOL[dtype]
                bad = (err > tol + tol * ref.float().abs()).sum().item()
                finite = bool(torch.isfinite(out.float()).all())
                same = torch.equal(out, out2) and (lse is None or torch.equal(lse, lse2))
                label = f"{name} {list(q.shape)}" + (f" keys {k.shape[2]}" if "nk" in shape else "") + (
                    f" {str(dtype)[6:]}")
                line = (f"check {label}: max_abs_err {err.max().item():.3e} (tol atol=rtol={tol:g}), out of "
                        f"tolerance {bad}, finite {finite}, second run bitwise equal {same}")
                ok = not bad and finite and same
                if lse is not None:
                    lse_err = (lse - ref_lse).abs()
                    lse_bad = (lse_err > FWD_LSE_TOL + FWD_LSE_TOL * ref_lse.abs()).sum().item()
                    masked = bool((lse[-1] == -1e30).all())
                    line += (f"; lse max_abs_err {lse_err.max().item():.3e} (tol atol=rtol={FWD_LSE_TOL:g}), "
                             f"out of tolerance {lse_bad}, -1e30 exactly on the fully masked batch {masked}")
                    ok = ok and not lse_bad and masked
                say(line)
                if not ok:
                    failures.append(label)
                if not shape:
                    errs[(name, dtype)] = err.max().item()
    if failures:
        fail(f"attention kernels disagree with their plain versions or themselves: {failures}")
    return errs


# ---------------------------------------------------------- attention key mass
def mass_inputs(gen, dev, dtype, b=2 * B, h=H, nq=N, nk=N, dh=D // H, fully_masked=False):
    """q, k and padded key and query masks (up to 300 padded keypoints of
    2048; up to half at small sizes); the last batch's keys all masked when
    fully_masked."""
    q = torch.randn((b, h, nq, dh), generator=gen).to(dev, dtype)
    k = torch.randn((b, h, nk, dh), generator=gen).to(dev, dtype)
    kmask = torch.arange(nk)[None] < padded_counts(gen, b, nk, max(nk - 300, nk // 2))[:, None]
    qmask = torch.arange(nq)[None] < padded_counts(gen, b, nq, max(nq - 300, nq // 2))[:, None]
    if fully_masked:
        kmask[-1] = False
    return q, k, kmask.to(dev), qmask.to(dev)


def mass_work(q, k, kmask, qmask) -> tuple[float, float, float]:
    """This call's work over valid (query, key) pairs of each batch only (a
    masked query adds 0 to every mass): (QK^T flops, 2 a multiply-add; one
    exponential a pair; the bytes of the valid q and k rows, the masks and
    the [B, Nk] fp32 output)."""
    b, h, nq, dh = q.shape
    nq_b, nk_b = qmask.sum(1).double(), kmask.sum(1).double()
    pairs = (nq_b * nk_b).sum().item()
    nbytes = q.element_size() * h * dh * (nq_b.sum() + nk_b.sum()).item() + (
        kmask.element_size() * kmask.numel() + qmask.element_size() * qmask.numel() + 4 * b * k.shape[2])
    return 2.0 * h * dh * pairs, float(h * pairs), nbytes


def mass_bound(q, k, kmask, qmask) -> tuple[float, str, float, float, float]:
    """The bf16 mass's least time: the QK^T at the bf16 tensor-core rate, the
    exponentials at the special-function rate, the bytes at the HBM rate.
    Returns (bound ms, what bounds it, ms of the QK^T, ms of the
    exponentials, ms of the bytes)."""
    flops, exps, nbytes = mass_work(q, k, kmask, qmask)
    t_qk, t_bytes = 1e3 * flops / PEAK_BF16, 1e3 * nbytes / HBM_BYTES_PER_S
    t_exp = 1e3 * exps / SFU_EXP_PER_S
    t = max(t_qk, t_exp, t_bytes)
    return t, ("bytes" if t == t_bytes else "operations"), t_qk, t_exp, t_bytes


MASS_ROUTES = ("lse", "standalone")


def mass_route(mha_fused_lse, route: str, q, k, kmask, qmask):
    """The wrapper's arguments of one route: the lse route takes kernel 4's
    row lse on the same q, k and key mask (as EIMP's pooling layers give it);
    the standalone route lets the wrapper launch its own row lse."""
    if route == "standalone":
        return q, k, kmask, qmask
    return q, k, kmask, qmask, mha_fused_lse(q, k, k, kmask)[1]


def mass_device_launches(attention_key_mass, args, calls: int = 4) -> float:
    """Device kernels of csrc/attention_mass.cu a wrapper call, from
    torch.profiler over `calls` calls (a profile around one call loses its
    last device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    attention_key_mass(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            attention_key_mass(*args)
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA and "key_mass" in e.name for e in prof.events()) / calls


def check_mass(dev, attention_key_mass, attention_key_mass_reference, mha_fused_lse):
    """Both routes of kernel 6 against the plain version at the main path's
    shape, EIMP's compacted sizes and a ragged shape with a fully masked batch
    (bf16 and fp32): twice for the same bits and through a CUDA-graph replay.
    On the lse route at the main shape, one device launch a call. Returns the
    largest error at the main shape by dtype."""
    gen = torch.Generator().manual_seed(7)
    worst, failures = {}, []
    ragged = dict(b=3, h=2, nq=333, nk=290, dh=32, fully_masked=True)
    shapes = [(torch.bfloat16, dict())] + [(torch.bfloat16, dict(nq=n, nk=n)) for _, n in EIMP_COMPACTION] + [
        (torch.bfloat16, ragged), (torch.float32, dict()), (torch.float32, ragged)]
    for dtype, shape in shapes:
        q, k, kmask, qmask = mass_inputs(gen, dev, dtype, **shape)
        ref = attention_key_mass_reference(q, k, kmask, qmask)
        outs = {}
        for route in MASS_ROUTES:
            args = mass_route(mha_fused_lse, route, q, k, kmask, qmask)
            out = attention_key_mass(*args)
            again = attention_key_mass(*args)
            torch.cuda.synchronize()
            outs[route] = out
            err = (out - ref).abs()
            bad = (err > MASS_ATOL + MASS_RTOL * ref.abs()).sum().item()
            finite = bool(torch.isfinite(out).all())
            same_bits = torch.equal(out, again)
            label = f"attention_key_mass {route} route q {list(q.shape)} k {list(k.shape)} {str(dtype)[6:]}"
            say(f"check {label}: max_abs_err {err.max().item():.3e} (tol rtol={MASS_RTOL:g} "
                f"atol={MASS_ATOL:g}), out of tolerance {bad}, finite {finite}, second run bitwise equal {same_bits}")
            if bad or not finite or not same_bits:
                failures.append(label)
            if not shape:
                if route == "lse":
                    worst[dtype] = err.max().item()
                per = mass_device_launches(attention_key_mass, args)
                say(f"check {label}: {per:.2f} device launches a wrapper call")
                if route == "lse" and per != 1:
                    failures.append(f"{label}: {per:.2f} device launches a call, want 1")
            graph_replay(label, attention_key_mass, args)
        say(f"check attention_key_mass q {list(q.shape)} {str(dtype)[6:]}: the two routes bitwise equal "
            f"{torch.equal(outs['lse'], outs['standalone'])} (reported, not a check)")
    if failures:
        fail(f"attention-mass kernel disagrees with its plain version or itself: {failures}")
    return worst


# ---------------------------------------------------------------- Sinkhorn
def sinkhorn_inputs(gen, dev, b=B, n=N, m=N, pad=300):
    """dist [B, N, M] and validity with up to `pad` padded keypoints an image
    (an image with none valid, possible at small sizes, has log-marginal
    -inf under the log-domain head)."""
    dist = (torch.randn((b, n, m), generator=gen) * 2).to(dev)
    v0 = torch.arange(n)[None] < padded_counts(gen, b, n, n - pad)[:, None]
    v1 = torch.arange(m)[None] < padded_counts(gen, b, m, m - pad)[:, None]
    return dist, torch.tensor(0.7, device=dev), v0.to(dev), v1.to(dev)


def sinkhorn_bound(dist, valid0, valid1) -> tuple[float, str, float]:
    """Least time: read the valid cells of dist once and write the outputs,
    versus the fp32 work of the valid (N+1) x (M+1) block: 2 flops per cell in
    each of the 2 * ITERS passes, plus softmax (3) and statistics (4)."""
    b, n, m = dist.shape
    n0, n1 = valid0.sum(1).double(), valid1.sum(1).double()
    nbytes = 4 * (n0 * n1).sum().item() + 4 * b * (n + 1 + m + 1 + 3 * n + 2 * m)
    flops = ((n0 + 1) * (n1 + 1)).sum().item() * (4 * ITERS + 7)
    return bound(flops, PEAK_FP32, nbytes)


def check_sinkhorn(dev, sinkhorn_fused_stats, sinkhorn_stats_reference, plan_dtype):
    """Kernel 2 against its plain version, and a second run for the same
    bits. Prints every check before failing on any. Returns the largest
    error at the main shape."""
    gen = torch.Generator().manual_seed(2)
    worst, failures = 0.0, []
    for shape in (dict(), dict(b=2, n=256, m=200)):      # bf16 plan; fp32 plan
        dist, bin_, v0, v1 = sinkhorn_inputs(gen, dev, **shape)
        out = sinkhorn_fused_stats(dist, bin_, ITERS, v0, v1)
        again = sinkhorn_fused_stats(dist, bin_, ITERS, v0, v1)
        torch.cuda.synchronize()
        ref = sinkhorn_stats_reference(dist, bin_, ITERS, v0, v1)
        pd = str(plan_dtype(dist.shape[1], dist.shape[2]))[6:]
        for key in ("u", "v", "max0", "rowmass", "colmass"):
            err = (out[key] - ref[key]).abs()
            bad = (err > SINK_ATOL + SINK_RTOL * ref[key].abs()).sum().item()
            worst = max(worst, err.max().item()) if not shape else worst
            say(f"check sinkhorn {list(dist.shape)} plan {pd} {key}: max_abs_err "
                f"{err.max().item():.3e} (tol rtol={SINK_RTOL:g} atol={SINK_ATOL:g}), out of tolerance {bad}")
            if bad or not bool(torch.isfinite(out[key]).all()):
                failures.append(f"{key} at {list(dist.shape)}")
        for key in ("idx0", "idx1"):
            flips = (out[key] != ref[key]).float().mean().item()
            say(f"check sinkhorn {list(dist.shape)} {key}: share differing {flips:.2e} (max {IDX_FLIP_MAX:g})")
            if flips > IDX_FLIP_MAX:
                failures.append(f"{key} at {list(dist.shape)}")
        same = all(torch.equal(out[k], again[k]) for k in out)
        say(f"check sinkhorn {list(dist.shape)}: second run bitwise equal {same}")
        if not same:
            failures.append(f"second run at {list(dist.shape)}")
        if not shape:
            graph_replay(f"sinkhorn_fused_stats {list(dist.shape)}", sinkhorn_fused_stats,
                         (dist, bin_, ITERS, v0, v1))
    if failures:
        fail(f"sinkhorn kernel disagrees with its plain version or itself: {failures}")
    return worst


def graph_replay(label: str, fn, args) -> None:
    """One wrapper call captured in a CUDA graph (its launches go through
    ctypes on the capturing stream) and replayed twice: the replay's outputs
    (a tensor or a dict of them) must equal a direct call's bits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)                                   # the capture stream's barrier words
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*args)
    graph.replay()
    graph.replay()
    direct = fn(*args)
    torch.cuda.synchronize()
    same = (torch.equal(captured, direct) if isinstance(direct, torch.Tensor)
            else all(torch.equal(captured[k], direct[k]) for k in direct))
    say(f"graph {label}: captured in a CUDA graph, replay bitwise equal to a direct call {same}")
    if not same:
        fail(f"{label}: a CUDA graph replay disagrees with a direct call")


def schedule_line(label: str, sched: dict) -> str:
    """The persistent kernel's schedule (csrc/persistent.cuh) as one line."""
    return (f"{label}: {sched['ctas']} CTAs ({sched['ctas_a_pair']} a pair), {sched['rows_on_chip']} rows "
            f"on chip ({sched['cap']} a CTA at most, {sched['smem_bytes']} bytes of shared memory), "
            f"{sched['overflow_rows']} rows in overflow = {sched['overflow_bytes'] / 1e6:.2f} MB read from "
            f"L2 twice an iteration")


# ---------------------------------------------------------------- main path
def permuted_pairs(gen, dev, b=B, n=N, d=D):
    """Pairs whose image 1 is a permutation of image 0 (small descriptor
    noise), with padded, permuted validity: a real share of keypoints match."""
    d0 = torch.randn((b, n, d), generator=gen)
    k0 = torch.rand((b, n, 2), generator=gen) - 0.5
    s0 = torch.rand((b, n), generator=gen)
    v0 = torch.arange(n)[None] < padded_counts(gen, b, n, n - 300)[:, None]
    perm = torch.stack([torch.randperm(n, generator=gen) for _ in range(b)])
    take = lambda x: torch.gather(x, 1, perm.view(perm.shape + (1,) * (x.dim() - 2)).expand_as(x))
    data = {"descriptors0": d0, "descriptors1": take(d0) + 0.01 * torch.randn((b, n, d), generator=gen),
            "norm_keypoints0": k0, "norm_keypoints1": take(k0), "scores0": s0, "scores1": take(s0),
            "valid0": v0, "valid1": take(v0)}
    return {k: x.to(dev) for k, x in data.items()}


def reference_layout(model, single_final_proj: bool = False) -> dict:
    """The model's weights in the reference checkpoint layout (Conv1d
    [out, in, 1]; MLP convs at indices 0, 3, 6, ..., a BatchNorm1d one index
    after its conv), as imp_spp.pth holds them; SuperGlue's one projection is
    `final_proj` (single_final_proj)."""
    sd = {}

    def conv(dst, blk):
        sd[f"{dst}.weight"] = blk.weight.detach().T[:, :, None].cpu()
        sd[f"{dst}.bias"] = blk.bias.detach().cpu()

    def mlp(dst, module):
        for i, blk in enumerate(module.blocks):
            conv(f"{dst}.{3 * i}", blk)
        for i, norm in enumerate(module.norms or ()):
            for name, t in zip(("weight", "bias", "running_mean", "running_var"), norm.stats()):
                sd[f"{dst}.{3 * i + 1}.{name}"] = t.detach().cpu()

    mlp("kenc.encoder", model.kenc)
    for i, layer in enumerate(model.gnn):
        src = f"gnn.layers.{i}"
        mlp(f"{src}.mlp", layer.mlp)
        if layer.shared:
            conv(f"{src}.proj", layer.proj)
            conv(f"{src}.merge", layer.merge)
        else:
            for j, name in enumerate(("q", "k", "v")):
                conv(f"{src}.attn.proj.{j}", layer.attn[name])
            conv(f"{src}.attn.merge", layer.attn["merge"])
    if single_final_proj:
        conv("final_proj", model.final_proj[0])
    else:
        for i, blk in enumerate(model.final_proj):
            conv(f"final_proj.{i}", blk)
    sd["bin_score"] = model.bin_score.detach().cpu()
    return sd


def carried_model(cls, cfg, dev, to_reference, from_reference, randomize=None):
    """A model with random weights from seed 0 (`randomize` may change them
    further), carried through the reference layout into a model built from
    seed 1; fails unless every weight and buffer comes back equal."""
    source = cls(cfg, device=dev, seed=0)
    if randomize is not None:
        randomize(source)
    model = cls(cfg, device=dev, seed=1)
    model.load_state_dict(from_reference(to_reference(source), cfg))
    for k, t in source.state_dict().items():
        if not torch.equal(t, model.state_dict()[k]):
            fail(f"{cls.__name__} weights carried through the reference layout differ at {k}")
    return model


# the plain versions of the inference kernels, by the module their wrappers look them up in
INFERENCE_PLAIN = {"attention": ("mha_reference", "mha_lse_reference", "attention_key_mass_reference",
                                 "attention_key_mass_from_lse_reference"),
                   "sinkhorn": ("sinkhorn_stats_reference",), "log_sinkhorn": ("log_sinkhorn_stats_reference",)}


@contextlib.contextmanager
def counting_inference_plain_bodies():
    """Count the calls of every inference kernel's plain version: a list of
    {name: calls}, one a module."""
    import importlib

    with contextlib.ExitStack() as stack:
        yield [stack.enter_context(counting_plain_bodies(importlib.import_module(f"impx_torch.ops.kernels.{mod}"),
                                                         names))
               for mod, names in INFERENCE_PLAIN.items()]


def drive_path(label, model, data, call, want, kernels, keeps=False):
    """One call through the kernels (every launch count set to 0 just
    before, read just after) and one through the plain path on the same
    inputs. Fails on launch counts other than `want` (every other kernel 0),
    on a kernel's plain version called on the kernel path, on a misshapen or
    non-finite output, on indices0 agreement under E2E_AGREE_MIN over valid
    rows, on keep agreement under EIMP_KEEP_AGREE_MIN over valid keypoints
    (keeps: EIMP), or on fewer matches than a quarter of the valid keypoints.
    Returns the launches."""
    for fn in kernels.values():
        fn.launches = 0
    with counting_inference_plain_bodies() as plain:
        out = call(data)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    plain_calls = {name: n for counts in plain for name, n in counts.items()}
    say(f"{label} launches per produce_matches call: {launches}; plain bodies called on the kernel path "
        f"{sum(plain_calls.values())}")
    if launches != {**dict.fromkeys(kernels, 0), **want}:
        fail(f"{label} did not run through the kernels as expected: {launches}")
    if any(plain_calls.values()):
        fail(f"{label}: a kernel's plain version ran on the kernel path: {plain_calls}")

    model.use_kernels = False
    ref = call(data)
    model.use_kernels = True
    idx, ridx = out["indices0"][-1], ref["indices0"][-1]
    valid = data["valid0"]
    agree = (idx == ridx)[valid].float().mean().item()
    n_match, n_valid = (idx >= 0).sum(1).tolist(), valid.sum(1).tolist()
    ms_err = (out["mscores0"][-1] - ref["mscores0"][-1]).abs().max().item()
    say(f"{label}: indices0 agreement with the plain path {agree:.4f} (min {E2E_AGREE_MIN}) "
        f"over valid rows; matches {n_match} of valid {n_valid} (plain {(ridx >= 0).sum(1).tolist()});"
        f" mscores0 max_abs_err {ms_err:.3e}")
    ok = agree >= E2E_AGREE_MIN
    if keeps:
        keep_agree = torch.cat([(out[f"keep{i}"] == ref[f"keep{i}"])[data[f"valid{i}"]] for i in (0, 1)])
        keep_agree = keep_agree.float().mean().item()
        say(f"{label}: keep agreement {keep_agree:.4f} (min {EIMP_KEEP_AGREE_MIN}) over valid keypoints; "
            f"final keep0 {out['keep0'].sum(1).tolist()} keep1 {out['keep1'].sum(1).tolist()}")
        ok = ok and keep_agree >= EIMP_KEEP_AGREE_MIN
    if idx.shape != valid.shape or not bool(torch.isfinite(out["mscores0"][-1]).all()):
        fail(f"{label} output has the wrong shape or non-finite scores")
    score = out["scores"][-1]
    if score is not None:
        (b, n), m = valid.shape, data["valid1"].shape[1]
        cells = torch.nn.functional.pad(valid[:, :, None] & data["valid1"][:, None, :], (0, 1, 0, 1), value=True)
        say(f"{label}: plan {list(score.shape)}, finite at every valid cell {bool(torch.isfinite(score[cells]).all())}")
        if score.shape != (b, n + 1, m + 1) or not bool(torch.isfinite(score[cells]).all()):
            fail(f"{label}: the plan is misshapen or not finite at valid cells")
    if not ok:
        fail(f"{label}: the kernel path disagrees with the plain path")
    if any(m < v / 4 for m, v in zip(n_match, n_valid)):
        fail(f"{label}: fewer matches than a quarter of the valid keypoints")
    return launches


def time_path(label, model, call, pairs):
    """pairs_per_s of the kernel path and of the plain path: the median of
    TIMED_RUNS CUDA-event timed calls over fresh inputs."""
    k_ms = cuda_ms(call, pairs)
    model.use_kernels = False
    p_ms = cuda_ms(call, pairs)
    model.use_kernels = True
    say(f"time {label}: kernel path {k_ms:.3f} ms = pairs_per_s {1e3 * B / k_ms:.2f}; "
        f"plain path {p_ms:.3f} ms = pairs_per_s {1e3 * B / p_ms:.2f}")


def norms_a_call(cfg) -> int:
    """The MLP norms of a match call: one a layer an image's side, and each
    encoder block's but the last, an image."""
    return 2 * (cfg.n_layers + len(cfg.keypoint_encoder))


def main_path(dev, DGNNS, MatcherConfig, load_reference_state_dict, kernels):
    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="bfloat16")
    model = carried_model(DGNNS, cfg, dev, reference_layout, load_reference_state_dict)
    say(f"main path: eval_config('spp', 15) bf16, {sum(l.shared for l in model.gnn)} of "
        f"{len(model.gnn)} layers share attention, B={B} N={N} D={D}")
    data = permuted_pairs(torch.Generator().manual_seed(3), dev)
    launches = drive_path("main path", model, data,
                          lambda d: model.produce_matches(d, only_last=True, with_scores=False),
                          {"mha_fused": 2 * cfg.n_layers, "sinkhorn_fused_stats": 1, "norm_act": norms_a_call(cfg)},
                          kernels)
    return model, launches


def host_us(fn, x, calls: int = WRAPPER_CALLS) -> float:
    """Median host-clock microseconds of one fn(*x) call (enqueue only: no
    synchronise inside the window), over `calls` calls on the same inputs."""
    fn(*x)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn(*x)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def time_all(dev, model, mods, errs, launches):
    (mha_fused, mha_reference, sinkhorn_fused_stats, sinkhorn_stats_reference, plan_dtype) = mods
    gen = torch.Generator().manual_seed(4)
    att = [attention_inputs(gen, dev, torch.bfloat16) for _ in range(4)]
    sdpa = lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=m[:, None, None, :])
    a_ms = cuda_ms(mha_fused, att)
    a_plain = cuda_ms(mha_reference, att)
    a_lib = cuda_ms(sdpa, att)
    a_bound, a_by, a_bytes = attention_bound(*att[0][::3])
    a_host, lib_host = host_us(mha_fused, att[0]), host_us(sdpa, att[0])
    a_queued, lib_queued = queued_ms(mha_fused, att), queued_ms(sdpa, att)
    sk = [sinkhorn_inputs(gen, dev) for _ in range(3)]
    run_k = lambda d, bn, a, b: sinkhorn_fused_stats(d, bn, ITERS, a, b)
    run_p = lambda d, bn, a, b: sinkhorn_stats_reference(d, bn, ITERS, a, b)
    s_ms, s_plain = cuda_ms(run_k, sk), cuda_ms(run_p, sk)
    s_queued = queued_ms(run_k, sk)
    s_bound, s_by, s_bytes = sinkhorn_bound(sk[0][0], *sk[0][2:])

    pairs = [(permuted_pairs(gen, dev),) for _ in range(4)]
    call = lambda d: model.produce_matches(d, only_last=True, with_scores=False)
    e2e_ms = cuda_ms(call, pairs)
    model.use_kernels = False
    e2e_plain = cuda_ms(call, pairs)
    model.use_kernels = True

    say(f"time mha_fused {list(att[0][0].shape)} bf16: ms {a_ms:.4f} bound_us {1e3 * a_bound:.2f} "
        f"({a_by}; bytes alone {1e3 * a_bytes:.2f} us) "
        f"launches {launches['mha_fused']} plain_ms {a_plain:.4f} library_ms {a_lib:.4f} (sdpa, bool mask)")
    say(f"host mha_fused {list(att[0][0].shape)} bf16 bool mask: {a_host:.2f} us a wrapper call (median of "
        f"{WRAPPER_CALLS} calls, host clock, enqueue only); sdpa {lib_host:.2f} us")
    say(f"time mha_fused queued: {a_queued:.4f} ms a call, 20 calls back to back (device time); sdpa "
        f"{lib_queued:.4f}")
    from impx_torch.ops.kernels import sinkhorn as ks

    b, n, m = sk[0][0].shape
    say(f"time sinkhorn_fused_stats {[b, n, m]}: ms {s_ms:.4f} (one call between two events) queued_ms "
        f"{s_queued:.4f} (20 calls back to back: device time) bound_us {1e3 * s_bound:.2f} "
        f"({s_by}; reading dist once {1e3 * s_bytes:.2f} us) "
        f"launches {launches['sinkhorn_fused_stats']} plain_ms {s_plain:.4f} library_ms none")
    say(schedule_line(f"schedule sinkhorn_fused_stats {[b, n, m]} plan {str(plan_dtype(n, m))[6:]}",
                      ks.schedule(b, n, m, dev)))
    say(f"time produce_matches B={B} N={N} 15 layers bf16: kernel path {e2e_ms:.3f} ms = "
        f"pairs_per_s {1e3 * B / e2e_ms:.2f}; plain path {e2e_plain:.3f} ms = "
        f"pairs_per_s {1e3 * B / e2e_plain:.2f}")
    return [
        {"name": "mha_fused", "route": "cuda", "source": "impx_torch/csrc/attention.cu",
         "replaces": "impx/ops/pallas/attention.py:203", "launches": launches["mha_fused"],
         "max_abs_err": errs["mha_fused"], "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": a_lib},
        {"name": "sinkhorn_fused_stats", "route": "cuda", "source": "impx_torch/csrc/sinkhorn.cu",
         "replaces": "impx/ops/pallas/sinkhorn.py:206",
         "launches": launches["sinkhorn_fused_stats"], "max_abs_err": errs["sinkhorn_fused_stats"],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None},
    ]


# ---------------------------------------------------------------- the MLP block's norm (kernel 8)
# the kernel against its plain version, as tests/test_torch_kernels.py holds
# it: fp32 moments summed in another order move y by a few ulps; under bf16
# both sides round y and the activation's output, a rounding flipping now and
# then by one bf16 ulp
NORM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2 ** -7, atol=1e-2)}
NORM_TIMED = {"yfcc": (8, 2000, 512), "4096": (4, 4096, 512)}   # the benchmark's layer norms, fp32
NORM_BEYOND_SMEM = (1, 60000, 512)   # a CTA's rows beyond its shared memory: read from device memory


def norm_inputs(gen, dev, dtype, r, n, c):
    """A product [r, n, c] with per-channel offsets and scales (so that the
    bias and the centring matter), its bias and a padding mask that leaves
    at least 85% of each image's tokens valid."""
    x = (torch.randn((r, n, c), generator=gen) * (0.5 + 2.5 * torch.rand(c, generator=gen))
         + 4 * torch.rand(c, generator=gen) - 2)
    bias = 2 * torch.rand(c, generator=gen) - 1
    valid = torch.arange(n)[None] < padded_counts(gen, r, n, int(0.85 * n))[:, None]
    return x.to(dev, dtype), bias.to(dev, dtype), valid.to(dev)


def check_norm(dev, norm_act, norm_act_reference) -> dict:
    """The kernel against its plain version on card tensors at the main
    path's shapes, the layers' [2B, N, 2D] and the encoder's [B, N, 32-256],
    in fp32 and bf16, and at one fp32 image whose rows exceed a CTA's shared
    memory; relu, gelu and leaky relu in turn. Fails outside NORM_TOL, or
    when two calls differ in a bit. Returns the largest error a dtype."""
    gen = torch.Generator().manual_seed(11)
    shapes = [(2 * B, N, 2 * D)] + [(B, N, c) for c in (32, 64, 128, 256)]
    cases = [(dtype, shape) for dtype in (torch.float32, torch.bfloat16) for shape in shapes]
    errs = {}
    for i, (dtype, shape) in enumerate(cases + [(torch.float32, NORM_BEYOND_SMEM)]):
        ac_fn = ("relu", "gelu", "lrelu")[i % 3]
        x, bias, valid = norm_inputs(gen, dev, dtype, *shape)
        with torch.no_grad():
            out, again = norm_act(x, bias, valid, ac_fn), norm_act(x, bias, valid, ac_fn)
            ref = norm_act_reference(x, bias, valid, ac_fn)
        err = (out.float() - ref.float()).abs().max().item()
        close = bool(torch.isclose(out.float(), ref.float(), **NORM_TOL[dtype]).all())
        same = torch.equal(out, again)
        say(f"check norm_act {list(shape)} {str(dtype)[6:]} {ac_fn} masked: max_abs_err {err:.3e} against the "
            f"plain chain (rtol = atol = {NORM_TOL[dtype]['rtol']:.3g}: {close}); the same bits twice {same}")
        if not (close and same):
            fail(f"norm_act {list(shape)} {dtype} {ac_fn}: outside the tolerance or not the same bits twice")
        errs[dtype] = max(errs.get(dtype, 0.0), err)
    return errs


def time_norm(dev, norm_act, norm_act_reference, errs, launches, eimp_launches) -> dict:
    """The kernel and the eager chain it replaces (norm_act_reference) at the
    benchmark's layer shapes in fp32 and at the main path's [2B, N, 2D] in
    bf16, masked: one call between two events, 20 calls queued, and 20 calls
    replayed from a CUDA graph (the device time alone: through the op a
    call's host time is about the kernel's, so the queued time is the
    host's); the bound, x read once and y written once at HBM_BYTES_PER_S;
    the host time of a call through the op. The kernels line's row, its
    times and bound at NORM_TIMED's first shape."""
    gen = torch.Generator().manual_seed(12)
    shapes = {**{f"{k} fp32": (torch.float32, s) for k, s in NORM_TIMED.items()},
              "main path bf16": (torch.bfloat16, (2 * B, N, 2 * D))}
    timed = {}
    with torch.no_grad():
        for label, (dtype, shape) in shapes.items():
            inputs = [norm_inputs(gen, dev, dtype, *shape) + ("relu",) for _ in range(3)]
            ms, queued, graph = cuda_ms(norm_act, inputs), queued_ms(norm_act, inputs), graph_ms(norm_act, inputs)
            plain, plain_graph = queued_ms(norm_act_reference, inputs), graph_ms(norm_act_reference, inputs)
            x = inputs[0][0]
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            timed[label] = {"shape": list(shape), "ms": ms, "queued_ms": queued, "graph_ms": graph,
                            "plain_ms": plain, "plain_graph_ms": plain_graph, "bound_ms": bound}
            say(f"time norm_act {list(shape)} {label} masked: ms {ms:.4f} (one call between two events) queued_ms "
                f"{queued:.4f} (20 calls back to back) graph_ms {graph:.4f} (20 calls in a CUDA graph: device time) "
                f"bound_us {1e3 * bound:.2f} (bytes: x read once, y written once; {bound / graph:.1%} of it) "
                f"plain_ms {plain:.4f} queued, {plain_graph:.4f} in a graph (the eager chain)")
        host = host_us(norm_act, inputs[0])
    say(f"host norm_act {list(shapes['main path bf16'][1])} bf16: {host:.2f} us a call through the op "
        f"impx::norm_act (median of {WRAPPER_CALLS} calls, host clock, enqueue only)")
    first = next(iter(timed.values()))
    return {"name": "norm_act", "route": "cuda", "source": "impx_torch/csrc/norm.cu", "replaces": None,
            "launches": launches, "launches_eimp": eimp_launches, "max_abs_err": errs[torch.bfloat16],
            **{k: v for k, v in first.items() if k != "shape"}, "bound_by": "bytes", "library_ms": None,
            "host_us": host, "shapes": timed, "fp32": {"max_abs_err": errs[torch.float32]}}


def device_kernels(fn, args, calls: int = 2) -> list[str]:
    """The device kernels of `calls` fn(*args) calls under torch.profiler,
    after a warm-up call, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def sdpa_backend(names: list[str]) -> str:
    """Which of scaled_dot_product_attention's backends ran, from its device
    kernels' names."""
    text = " ".join(names).lower()
    for key, backend in (("flash", "flash"), ("cudnn", "cuDNN"), ("fmha", "memory-efficient"),
                         ("efficient", "memory-efficient")):
        if key in text:
            return backend
    return f"math ({len(set(names))} kinds of kernel)"


def time_fp32_forward(dev, ka, errs) -> dict:
    """Kernels 1 and 4 at fp32 (attn_fwd_tf32x3) at the main path's shape:
    one call between two events, 20 queued, both bounds, the plain version,
    and scaled_dot_product_attention at fp32 with the bool mask (its backend
    named). Returns each kernel's JSON "fp32" entry."""
    gen = torch.Generator().manual_seed(12)
    att = [attention_inputs(gen, dev, torch.float32) for _ in range(4)]
    sdpa = lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=m[:, None, None, :])
    names = device_kernels(sdpa, att[0])
    backend = sdpa_backend(names)
    lib_ms, lib_queued = cuda_ms(sdpa, att), queued_ms(sdpa, att)
    flops, exps, nbytes = attention_work(att[0][0], att[0][3])
    b = fp32_bounds(flops, exps, nbytes)
    say(f"time sdpa {list(att[0][0].shape)} fp32 bool mask: {backend} backend, device kernels "
        f"{sorted(set(n[:60] for n in names))}; ms {lib_ms:.4f} queued_ms {lib_queued:.4f}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    rows = {}
    for name, fn, plain in (("mha_fused", ka.mha_fused, ka.mha_reference),
                            ("mha_fused_lse", ka.mha_fused_lse, ka.mha_lse_reference)):
        ms, q_ms, p_ms = cuda_ms(fn, att), queued_ms(fn, att), cuda_ms(plain, att)
        say(f"time {name} {list(att[0][0].shape)} fp32: ms {ms:.4f} (one call between two events) queued_ms "
            f"{q_ms:.4f} (20 calls back to back); {bounds_text(b)} (the exponentials "
            f"{1e3 * exps / SFU_EXP_PER_S:.4f} ms, the bytes {1e3 * nbytes / HBM_BYTES_PER_S:.4f}); plain_ms "
            f"{p_ms:.4f} library_ms {lib_ms:.4f} (sdpa, {backend}); {F32_ATTN_MS_BEFORE} ms a launch profiled "
            f"before the 3xTF32 redesign")
        rows[name] = {"ms": ms, "queued_ms": q_ms, "plain_ms": p_ms, "bound_ms": b["tf32x3"][0],
                      "bound_by": f"{b['tf32x3'][1]} (3xTF32)", "bound_fma_ms": b["fma"][0],
                      "library_ms": lib_ms, "library_queued_ms": lib_queued, "library": f"sdpa ({backend})",
                      "max_abs_err": errs[(name, torch.float32)]}
    return rows


def kernel_name(mangled: str) -> str:
    """`name<template integers>` of a kernel in an anonymous namespace, from
    its mangled name `_ZN<n><namespace><n><name>I<arguments>E...`, so that
    ptxas's registers and spills carry the kernel they belong to; otherwise
    the mangled name as it is."""
    head = re.match(r"_ZN(\d+)", mangled)
    rest = mangled[head.end() + int(head.group(1)):] if head else ""
    size = re.match(r"\d+", rest)
    if size is None:
        return mangled
    end = size.end() + int(size.group())
    args = re.match(r"I((?:L[a-z]\d+E)+)E", rest[end:])
    values = re.findall(r"L[a-z](\d+)E", args.group(1)) if args else []
    return rest[size.end():end] + (f"<{', '.join(values)}>" if values else "")


def forward_resources(log: str | None, lib) -> None:
    """One line per instantiation of the bf16 attention forward
    (attn_fwd_wgmma<dh>): ptxas's registers, spills and static shared memory,
    and the dynamic shared memory a block takes at the main path's 2048 keys
    and the training path's 1024."""
    if log is None:
        say("ptxas attn_fwd_wgmma: not compiled in this process (a library of this source was already built)")
        return
    kernel, spills = None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = kernel_name(line.split()[-1])
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel and kernel.startswith("attn_fwd_wgmma"):
            used = line.split(":", 1)[1].strip()
            dh = int(re.search(r"<(\d+)>", kernel).group(1))
            say(f"ptxas {kernel}: {used}; {spills}; dynamic smem a block "
                f"{lib.impx_mha_fwd_smem_bytes(dh, N, 1)} bytes at Nk = {N}, "
                f"{lib.impx_mha_fwd_smem_bytes(dh, TN, 1)} at Nk = {TN}")


def f32_resources(logs: dict) -> None:
    """One line per instantiation of the fp32 kernels in 3xTF32: the forward
    attn_fwd_tf32x3<dh, 1> (kernels 1 and 4), its row lse alone
    attn_fwd_tf32x3<dh, 0> and the mass key_mass_tf32x3<dh> (kernel 6):
    ptxas's registers and spills, and the dynamic shared memory a block at
    the main path's 2048 queries or keys."""
    from impx_torch.ops.kernels import _build

    for name in ("attention", "attention_mass"):
        log = logs.get(name)
        if log is None:
            say(f"ptxas {name} fp32 kernels: not compiled in this process (a library of this source was already "
                f"built)")
            continue
        lib = _build.load(name)
        kernel, spills = None, ""
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = kernel_name(line.split()[-1])
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line and "registers" in line and kernel and "tf32x3" in kernel:
                dh = int(re.search(r"<(\d+)", kernel).group(1))
                if kernel.startswith("key_mass"):
                    smem = lib.impx_attention_mass_f32_smem_bytes(dh, N, 0)
                elif kernel.endswith(", 0>"):
                    smem = lib.impx_attention_mass_f32_smem_bytes(dh, N, 1)
                else:
                    smem = lib.impx_mha_fwd_smem_bytes(dh, N, 0)
                say(f"ptxas {kernel}: {line.split(':', 1)[1].strip()}; {spills}; dynamic smem a block {smem} "
                    f"bytes at N = {N}")


def persistent_resources(logs: dict) -> None:
    """One line per instantiation of the persistent Sinkhorn kernels
    (sinkhorn_persistent, log_sinkhorn_persistent; plan or Z in fp32 or
    bf16): ptxas's registers and spills, and the dynamic shared memory a CTA
    at the main path's dist [B, N, N] from the schedule query."""
    from impx_torch.ops.kernels import log_sinkhorn as kl
    from impx_torch.ops.kernels import sinkhorn as ks

    for name, module in (("sinkhorn", ks), ("log_sinkhorn", kl)):
        log = logs.get(name)
        if log is None:
            say(f"ptxas {name}_persistent: not compiled in this process (a library of this source was "
                f"already built)")
            continue
        kernel, spills = None, ""
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = line.split()[-1]
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line and "registers" in line and kernel and f"{name}_persistent" in kernel:
                dtype = "bf16" if "bfloat16" in kernel else "fp32"
                sched = module.schedule(B, N, N)
                say(f"ptxas {name}_persistent<{dtype}>: {line.split(':', 1)[1].strip()}; {spills}; dynamic "
                    f"smem a CTA {sched['smem_bytes']} bytes at dist {[B, N, N]} "
                    f"({str(ks.plan_dtype(N, N))[6:]} rule)")


def check_sass() -> None:
    """Every built function that issues wgmma, read in its machine code by
    impx_torch/tools/sass_check.py: no instruction overwrites a register that
    an HGMMA reads or writes while it is in flight, or a fragment that a
    loop's HGMMA reads and only code before the loop writes. ptxas built the
    fp32 forward with one TF32 pass so, from right PTX (PERF.md section 7):
    right at one key tile, wrong from the second."""
    from impx_torch.ops.kernels import _build
    from impx_torch.tools.sass_check import library_faults

    checked, bad = 0, {}
    for name in sorted(_build.SIGNATURES):
        for fn, found in library_faults(_build._target(name)).items():
            checked += 1
            if found:
                bad[kernel_name(fn)] = found[:2]
    say(f"sass check: {checked} built functions issue wgmma, {len(bad)} with a register fault")
    if bad:
        fail(f"wgmma register faults in the built kernels: {bad}")


KERNEL_GROUPS = (  # device kernel name -> the layer that launched it (first match)
    ("mha_fused, mha_fused_lse (csrc/attention.cu)", ("attn_fwd",)),
    ("log_sinkhorn_fused_stats (csrc/log_sinkhorn.cu)", ("log_sinkhorn_persistent",)),
    ("mha_bwd (csrc/attention_bwd.cu)", ("bwd_dq_recompute", "bwd_dkdv_recompute")),
    ("mha_bwd_from_lse (csrc/attention_bwd.cu)", ("bwd_dq_lse", "bwd_dkdv_lse")),
    ("sinkhorn_fused_stats (csrc/sinkhorn.cu)", ("sinkhorn_persistent",)),
    ("attention_key_mass (csrc/attention_mass.cu)", ("key_mass",)),
    ("norm_act (csrc/norm.cu)", ("norm_act_cluster",)),
    ("matmul (cuBLAS)", ("gemm", "gemv", "sm90_", "cutlass", "nvjet", "xmma")),
)

# kernel group -> its wrappers, whose launch counts give the wrapper calls of a
# profile (filled in main, where the package is imported)
GROUP_WRAPPERS: dict[str, tuple] = {}
PERSISTENT_GROUPS = (KERNEL_GROUPS[1][0], KERNEL_GROUPS[4][0])   # kernels 7 and 2
PERSISTENT_LAUNCHES_MAX = 3        # device launches a wrapper call of kernel 2 or 7


def profile_calls(label: str, call, inputs, kernel_groups=KERNEL_GROUPS) -> dict | None:
    """torch.profiler over one call per input: the device time per call by
    kernel group (the first of `kernel_groups` whose keys a kernel's name
    holds) and by kernel, and the device's idle share of the window from its
    first to its last kernel. Returns (device ms, device launches) per call
    of each kernel group, None if the profiler recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = len(inputs)
    call(inputs[0])
    torch.cuda.synchronize()
    wrapper_calls = {g: -sum(fn.launches for fn in fns) for g, fns in GROUP_WRAPPERS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for data in inputs:
            call(data)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    for g, fns in GROUP_WRAPPERS.items():
        wrapper_calls[g] += sum(fn.launches for fn in fns)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        say("profile: the profiler recorded no device events; breakdown not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:                       # union of kernel intervals, us
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    window = spans[-1][1] - spans[0][0]
    say(f"profile {label}: {calls} calls, host wall {wall_ms:.3f} ms/call, "
        f"device busy {busy / 1e3 / calls:.3f} ms/call, idle share {1 - busy / window:.3f} "
        f"of the kernel window, {len(kernels) / calls:.0f} device ops/call")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    groups = {g: [0.0, 0] for g, _ in kernel_groups}
    groups["other PyTorch kernels (norm, elementwise, copies)"] = [0.0, 0]
    for name, ts in by_name.items():
        g = next((g for g, keys in kernel_groups if any(k in name for k in keys)),
                 "other PyTorch kernels (norm, elementwise, copies)")
        groups[g][0] += sum(ts)
        groups[g][1] += len(ts)
    for g, (t, n) in groups.items():
        say(f"profile group {g}: {t / 1e3 / calls:.3f} ms/call, {n / calls:.0f} launches/call, "
            f"{t / busy:.3f} of busy")
    for g, wrapped in wrapper_calls.items():
        if wrapped and g in groups:
            per = groups[g][1] / wrapped
            say(f"profile {label} {g}: {groups[g][1]} device launches over {wrapped} wrapper calls = "
                f"{per:.2f} a wrapper call")
            if g in PERSISTENT_GROUPS and per > PERSISTENT_LAUNCHES_MAX:
                fail(f"{g}: {per:.2f} device launches a wrapper call (at most {PERSISTENT_LAUNCHES_MAX})")
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]:
        say(f"profile kernel {sum(ts) / 1e3 / calls:.3f} ms/call x{len(ts) / calls:.0f}: {name[:110]}")
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    for e in host:  # where the host's time goes: dispatch, launches, any synchronisation
        say(f"profile host {e.self_cpu_time_total / 1e3 / calls:.3f} ms/call self x{e.count / calls:.0f}: "
            f"{e.key[:90]}")
    return {g: (t / 1e3 / calls, n / calls) for g, (t, n) in groups.items()}


def profile_main_path(dev, model, calls: int = 4):
    gen = torch.Generator().manual_seed(5)
    pairs = [permuted_pairs(gen, dev) for _ in range(calls)]
    groups = profile_calls(f"produce_matches B={B} N={N}",
                           lambda d: model.produce_matches(d, only_last=True, with_scores=False), pairs)
    if groups is not None:
        ms, n = groups[KERNEL_GROUPS[0][0]]
        say(f"profile produce_matches attention group: {ms:.3f} ms/call over {n:.0f} launches; "
            f"{ATTN_GROUP_MS_BEFORE} ms/call before the bf16 forward's redesign (PERF.md section 5)")


# ---------------------------------------------------------------- EIMP
def overlap_pairs(gen, dev, b=B, n=N, d=D):
    """Pairs that overlap in part: about half of image 1's slots hold a
    permuted, lightly noised copy of an image 0 keypoint, the rest fresh
    random keypoints; 0-300 padded keypoints per image. Some keypoints match
    and the rest can be pooled away (fully permuted pairs match nearly every
    row, and pooling then keeps nearly all). The validity is a padded suffix
    in each image, as keypoint sets padded to a bucket have, drawn per image;
    tests/test_torch_kernels.py:overlap_pairs scatters validity instead, to
    exercise the compaction gathers, and carries it through the permutation."""
    d0, d1 = torch.randn((2, b, n, d), generator=gen)
    k0, k1 = torch.rand((2, b, n, 2), generator=gen) - 0.5
    s0, s1 = torch.rand((2, b, n), generator=gen)
    v0 = torch.arange(n)[None] < padded_counts(gen, b, n, n - 300)[:, None]
    v1 = torch.arange(n)[None] < padded_counts(gen, b, n, n - 300)[:, None]
    perm = torch.stack([torch.randperm(n, generator=gen) for _ in range(b)])
    take = lambda x: torch.gather(x, 1, perm.view(perm.shape + (1,) * (x.dim() - 2)).expand_as(x))
    shared = torch.rand((b, n), generator=gen) < 0.5
    pick = lambda a, c: torch.where(shared.view(shared.shape + (1,) * (a.dim() - 2)), a, c)
    data = {"descriptors0": d0, "descriptors1": pick(take(d0) + 0.01 * torch.randn((b, n, d), generator=gen), d1),
            "norm_keypoints0": k0, "norm_keypoints1": pick(take(k0), k1),
            "scores0": s0, "scores1": pick(take(s0), s1), "valid0": v0, "valid1": v1}
    return {k: x.to(dev) for k, x in data.items()}


def eimp_models(dev, AdaGMN, MatcherConfig, load_reference_state_dict) -> dict:
    """Both EIMP variants at eval_config('spp', 15) in bf16, with one set of
    random weights carried through the reference-checkpoint loader."""
    base = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="bfloat16")
    source = AdaGMN(base, device=dev, seed=0)
    source.bin_score.data.fill_(EIMP_BIN_SCORE)
    state = load_reference_state_dict(reference_layout(source), base)
    models = {}
    for name, compaction in (("mask-only", ()), ("compacted", EIMP_COMPACTION)):
        model = AdaGMN(dataclasses.replace(base, compaction=compaction), device=dev, seed=1)
        model.load_state_dict(state)
        for k, t in source.state_dict().items():
            if not torch.equal(t, model.state_dict()[k]):
                fail(f"EIMP weights carried through the reference layout differ at {k}")
        models[name] = model
    say(f"eimp: eval_config('spp', 15) bf16, n_min_tokens {base.n_min_tokens}, first_it_to_update "
        f"{base.first_it_to_update}, bin_score {EIMP_BIN_SCORE}, compacted schedule {EIMP_COMPACTION}, "
        f"B={B} N={N} D={D}")
    return models


def eimp_path(dev, models, kernels, pool_its):
    """Each variant once through the kernels (launches counted from 0), then
    through the plain path on the same inputs. Fails on wrong launch counts,
    on pooling that dropped nothing in every pair, on disagreement with the
    plain path or non-finite scores. Returns the mask-only run's launches."""
    gen = torch.Generator().manual_seed(6)
    data = overlap_pairs(gen, dev)
    valid = (data["valid0"], data["valid1"])
    n_valid = [v.sum(1) for v in valid]
    n_layers = models["mask-only"].config.n_layers
    # a pooling iteration's two layers run kernel 4 for the row lse its masses take
    want = {**dict.fromkeys(kernels, 0), "mha_fused": 2 * (n_layers - len(pool_its)),
            "mha_fused_lse": 2 * len(pool_its), "sinkhorn_fused_stats": n_layers,
            "attention_key_mass": 2 * len(pool_its), "norm_act": norms_a_call(models["mask-only"].config)}
    dropped_any = False
    first_launches = None
    for name, model in models.items():
        pools = []

        def recording(*args, _orig=model._pool_from_masses):
            keep0, keep1 = args[6], args[7]
            new0, new1 = _orig(*args)
            pools.append((keep0.sum(1), keep1.sum(1), new0.sum(1), new1.sum(1)))
            return new0, new1

        model._pool_from_masses = recording
        for fn in kernels.values():
            fn.launches = 0
        out = model.produce_matches(data, only_last=True, with_scores=False)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        del model._pool_from_masses
        first_launches = first_launches or launches
        say(f"eimp {name}: launches per produce_matches call {launches}")
        if launches != want:
            fail(f"EIMP {name} did not run through the kernels as expected: {launches}, want {want}")
        after = {}
        for it, counts in zip(pool_its, pools):
            b0, b1, a0, a1 = (c.tolist() for c in counts)
            after[it] = (a0, a1)
            dropped_any |= any(a < b for a, b in zip(a0 + a1, b0 + b1))
            say(f"eimp {name} pool at iteration {it}: keep0 {b0} -> {a0}, keep1 {b1} -> {a1}")
        if "overflow0" in out:
            totals = [torch.zeros_like(out["overflow0"]), torch.zeros_like(out["overflow1"])]
            for it, k in EIMP_COMPACTION:
                last = max((p for p in pool_its if p < it), default=None)
                entering = after[last] if last is not None else [x.tolist() for x in n_valid]
                over = [[max(c - k, 0) for c in side] for side in entering]
                totals = [t + torch.tensor(o, device=t.device, dtype=t.dtype) for t, o in zip(totals, over)]
                say(f"eimp {name} compaction before iteration {it} into {k}: kept {entering[0]} / "
                    f"{entering[1]}, overflow per pair {over[0]} / {over[1]}")
            say(f"eimp {name} overflow0 {out['overflow0'].tolist()} overflow1 {out['overflow1'].tolist()} "
                "(reported, not a failure: random weights decide how many survive)")
            if not (torch.equal(totals[0], out["overflow0"]) and torch.equal(totals[1], out["overflow1"])):
                fail(f"EIMP {name}: overflow totals disagree with the keep counts")

        model.use_kernels = False
        ref = model.produce_matches(data, only_last=True, with_scores=False)
        model.use_kernels = True
        idx, ridx = out["indices0"][0], ref["indices0"][0]
        agree = (idx == ridx)[valid[0]].float().mean().item()
        keep_agree = torch.cat([(out[f"keep{i}"] == ref[f"keep{i}"])[valid[i]] for i in (0, 1)])
        keep_agree = keep_agree.float().mean().item()
        ms_err = (out["mscores0"][0] - ref["mscores0"][0]).abs().max().item()
        say(f"eimp {name}: indices0 agreement with the plain path {agree:.4f} (min {E2E_AGREE_MIN}) "
            f"over valid rows, keep agreement {keep_agree:.4f} (min {EIMP_KEEP_AGREE_MIN}) over valid "
            f"keypoints; matches {(idx >= 0).sum(1).tolist()} (plain {(ridx >= 0).sum(1).tolist()}) of "
            f"valid {n_valid[0].tolist()}; final keep0 {out['keep0'].sum(1).tolist()} (plain "
            f"{ref['keep0'].sum(1).tolist()}); mscores0 max_abs_err {ms_err:.3e}")
        if idx.shape != valid[0].shape or not bool(torch.isfinite(out["mscores0"][0]).all()):
            fail(f"EIMP {name} output has the wrong shape or non-finite scores")
        if agree < E2E_AGREE_MIN or keep_agree < EIMP_KEEP_AGREE_MIN:
            fail(f"EIMP {name} kernel path disagrees with the plain path")
    if not dropped_any:
        fail("no pool dropped a keypoint in any pair: pooling was not exercised")
    return first_launches


def time_eimp(dev, models, mods, err, launches):
    from impx_torch.ops.kernels import _build

    attention_key_mass, attention_key_mass_reference, mha_fused_lse = mods
    gen = torch.Generator().manual_seed(8)
    ins = [mass_inputs(gen, dev, torch.bfloat16) for _ in range(4)]
    m_bound, m_by, m_qk, m_exp, m_bytes = mass_bound(*ins[0])
    m_plain = cuda_ms(attention_key_mass_reference, ins)
    one_call = {}
    for route in MASS_ROUTES:
        args = [mass_route(mha_fused_lse, route, *x) for x in ins]
        one_call[route] = cuda_ms(attention_key_mass, args)
        say(f"time attention_key_mass {route} route {list(ins[0][0].shape)} bf16: ms {one_call[route]:.4f} "
            f"(one call between two events) queued_ms {queued_ms(attention_key_mass, args):.4f} (20 calls back "
            f"to back) graph_ms {graph_ms(attention_key_mass, args):.4f} (20 calls in a CUDA graph: device time) "
            f"bound_us {1e3 * m_bound:.2f} ({m_by}: the larger of the QK^T {1e3 * m_qk:.2f} us, the exponentials "
            f"{1e3 * m_exp:.2f} us at the special-function rate and the bytes {1e3 * m_bytes:.2f} us) launches "
            f"{launches['attention_key_mass']} plain_ms {m_plain:.4f} library_ms none")
    lib = _build.load("attention_mass")
    for _, n in EIMP_COMPACTION:   # the split of EIMP's compacted sizes, by device time
        small = [mass_route(mha_fused_lse, "lse", *mass_inputs(gen, dev, torch.bfloat16, nq=n, nk=n))
                 for _ in range(2)]
        by_split = ", ".join(f"{sp}: {graph_ms(lambda *a, sp=sp: attention_key_mass(*a, splits=sp), small):.4f}"
                             for sp in (1, 2, 4, 8, 16))
        q = small[0][0]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        default = lib.impx_attention_key_mass_splits(q.shape[0], q.shape[1], n, n, 1, sms)
        say(f"time attention_key_mass lse route {list(q.shape)} graph_ms by splits {{{by_split}}}; the default "
            f"takes {default}")
    pairs = [(overlap_pairs(gen, dev),) for _ in range(4)]
    for name, model in models.items():
        call = lambda d: model.produce_matches(d, only_last=True, with_scores=False)
        k_ms = cuda_ms(call, pairs)
        model.use_kernels = False
        p_ms = cuda_ms(call, pairs)
        model.use_kernels = True
        say(f"time eimp {name} produce_matches B={B} N={N} 15 layers bf16: kernel path {k_ms:.3f} ms "
            f"= pairs_per_s {1e3 * B / k_ms:.2f}; plain path {p_ms:.3f} ms = pairs_per_s "
            f"{1e3 * B / p_ms:.2f}")
    return {"name": "attention_key_mass", "route": "cuda", "source": "impx_torch/csrc/attention_mass.cu",
            "replaces": "impx/ops/pallas/attention.py:422", "launches": launches["attention_key_mass"],
            "max_abs_err": err, "ms": one_call["lse"], "plain_ms": m_plain, "bound_ms": m_bound,
            "bound_by": m_by, "library_ms": None}


def time_fp32_mass(dev, attention_key_mass, attention_key_mass_reference, mha_fused_lse, err) -> dict:
    """Kernel 6 at fp32 (key_mass_tf32x3; the standalone route's row lse
    attn_fwd_tf32x3<dh, 0>) at the main path's shape on both routes: one
    call, 20 queued, a CUDA graph's device time, both bounds, the plain
    version. Returns the JSON row's "fp32" entry (the lse route's times)."""
    gen = torch.Generator().manual_seed(13)
    ins = [mass_inputs(gen, dev, torch.float32) for _ in range(4)]
    flops, exps, nbytes = mass_work(*ins[0])
    b = fp32_bounds(flops, exps, nbytes)
    m_plain = cuda_ms(attention_key_mass_reference, ins)
    out = {}
    for route in MASS_ROUTES:
        args = [mass_route(mha_fused_lse, route, *x) for x in ins]
        t = {"ms": cuda_ms(attention_key_mass, args), "queued_ms": queued_ms(attention_key_mass, args),
             "graph_ms": graph_ms(attention_key_mass, args)}
        say(f"time attention_key_mass {route} route {list(ins[0][0].shape)} fp32: ms {t['ms']:.4f} (one call "
            f"between two events) queued_ms {t['queued_ms']:.4f} graph_ms {t['graph_ms']:.4f}; {bounds_text(b)} "
            f"(the exponentials {1e3 * exps / SFU_EXP_PER_S:.4f} ms, the bytes {1e3 * nbytes / HBM_BYTES_PER_S:.4f}); "
            f"plain_ms {m_plain:.4f}; {F32_MASS_MS_BEFORE} ms a launch profiled before the 3xTF32 redesign")
        out[route] = t
    return {**out["lse"], "standalone_graph_ms": out["standalone"]["graph_ms"], "plain_ms": m_plain,
            "bound_ms": b["tf32x3"][0], "bound_by": f"{b['tf32x3'][1]} (3xTF32)", "bound_fma_ms": b["fma"][0],
            "library_ms": None, "max_abs_err": err}


# ---------------------------------------------------------------- the eval path
# configs/yfcc_eval_gm.yaml: SuperPoint at 2000 keypoints (bucket round_up(2000,
# 128) = 2048), the evaluator's inlier_th; YFCC's pose threshold is 1 pixel
# (impx_torch/eval/eval_imp.py:main). The values are written out here: the
# phase reads no YAML and no HDF5 (the card's machine has no h5py).
EVAL_PAIRS, EVAL_BATCH, EVAL_KPT = 16, 4, 2000
EVAL_CONFIG = {"rescale": 1600, "inlier_th": 0.005}
EVAL_ERROR_PX = 1.0
# synthesize_pair's descriptors have unit norm; random weights then match
# almost no true pair (tests/test_torch_eval.py). At 16x, unit variance an
# entry as the main path's pairs, they match every true pair at N = 256.
EVAL_DESC_SCALE = 16.0
POSE_EQUAL_DEG = 1e-3             # pose errors of equal match sets, kernel vs plain path
# pose recovery from true correspondences plus random pairings of outlier
# keypoints (30% of the set), at tests/test_ransac.py:25-45's limits, held on
# every pair with at least RECOVERY_MIN_TRUE true correspondences. A pair whose
# views overlap little has fewer, bunched in a corner of the image: one with 320
# gives translation errors of 1.35-3.59 deg under impx's estimate_pose_jax
# (three keys) and the port alike, so those pairs are printed, not held.
RECOVERY_OUTLIER_SHARE = 0.3
RECOVERY_DEG, RECOVERY_RECALL_MIN, RECOVERY_ADMIT_MAX = 1.5, 0.8, 0.1
RECOVERY_MIN_TRUE = 500


class SyntheticReader:
    """StandardReader's interface (num_kpt, __len__, run(index)) over seeded
    pairs of impx_torch.data.synthetic at the YFCC eval widths (256-wide
    descriptors, 640 x 480, about 1000 true correspondences and 1000 outliers a
    side): run returns StandardReader.run's dict, t L2-normalised, keypoints
    truncated to num_kpt; descriptors scaled by EVAL_DESC_SCALE."""

    def __init__(self, n_pairs: int, num_kpt: int, seed: int, n_inliers: int = 1000, n_outliers: int = 1000):
        from impx_torch.data.synthetic import synthesize_pair

        rs = np.random.RandomState(seed)
        self.pairs = [synthesize_pair(rs, n_inliers=n_inliers, n_outliers0=n_outliers,
                                      n_outliers1=n_outliers, desc_dim=D, image_size=(480, 640))
                      for _ in range(n_pairs)]
        self.num_kpt = num_kpt

    def __len__(self):
        return len(self.pairs)

    def run(self, index: int) -> dict:
        p, k = self.pairs[index], self.num_kpt
        t = p["T"] / (p["T"] ** 2).sum() ** 0.5
        return {"index": index, "K1": p["K1"], "K2": p["K2"], "R": p["R"], "t": t,
                "x1": p["kpt1"][:k], "x2": p["kpt2"][:k],
                "desc1": EVAL_DESC_SCALE * p["desc1"][:k], "desc2": EVAL_DESC_SCALE * p["desc2"][:k],
                "e": p["e"], "f": p["f"], "r_gt": p["R"], "t_gt": t,
                "img_size1": tuple(p["img_size1"]), "img_size2": tuple(p["img_size2"])}


class EvalArgs:
    """evaluate's arguments as the CLI gives them, with the device pose backend."""
    max_pairs, bucket, eval_batch, pose_backend = -1, -1, EVAL_BATCH, "device"


def pose_recovery(dev, reader):
    """The device backend on each pair's true correspondences plus random
    pairings of outlier keypoints (RECOVERY_OUTLIER_SHARE of the set), at the
    eval threshold, one generator a pair. Fails unless every pair with at
    least RECOVERY_MIN_TRUE true correspondences meets the limits (and they
    are at least half the pairs). Returns the first EVAL_BATCH pairs' (x0, x1 normalized numpy,
    threshold, index)."""
    from impx_torch.eval.evaluator import pair_generator
    from impx_torch.geometry.pose import angle_error_mat, angle_error_vec
    from impx_torch.ransac.pose_solver import _norm_threshold, estimate_pose_device

    rs = np.random.RandomState(21)
    rows, inputs = [], []
    for i, p in enumerate(reader.pairs):
        gt = p["gt_matches"]
        n_in = len(gt)
        n_out = int(round(n_in * RECOVERY_OUTLIER_SHARE / (1 - RECOVERY_OUTLIER_SHARE)))
        out0 = np.setdiff1d(np.arange(len(p["kpt1"])), gt[:, 0])
        out1 = np.setdiff1d(np.arange(len(p["kpt2"])), gt[:, 1])
        i0 = np.concatenate([gt[:, 0], rs.choice(out0, n_out)])
        i1 = np.concatenate([gt[:, 1], rs.choice(out1, n_out)])
        norm = lambda x, K: (x[:, :2] - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])  # noqa: E731
        n0, n1 = norm(p["kpt1"][i0], p["K1"]), norm(p["kpt2"][i1], p["K2"])
        x0 = torch.tensor(n0, dtype=torch.float32, device=dev)
        x1 = torch.tensor(n1, dtype=torch.float32, device=dev)
        thresh = _norm_threshold(EVAL_ERROR_PX, p["K1"], p["K2"])
        out = estimate_pose_device(pair_generator(dev, 0, i), x0, x1,
                                   torch.ones(len(i0), dtype=torch.bool, device=dev), thresh)
        err_R = float(angle_error_mat(torch.tensor(p["R"], dtype=torch.float32), out["R"].cpu()))
        err_t = float(angle_error_vec(torch.tensor(p["T"], dtype=torch.float32), out["t"].cpu()))
        inl = out["inliers"].cpu()
        rows.append((n_in, err_R, err_t, inl[:n_in].float().mean().item(), inl[n_in:].float().mean().item()))
        if len(inputs) < EVAL_BATCH:
            inputs.append((n0, n1, thresh, i))
    held = [r for r in rows if r[0] >= RECOVERY_MIN_TRUE]
    say(f"eval pose recovery, threshold {EVAL_ERROR_PX} px, true correspondences plus "
        f"{RECOVERY_OUTLIER_SHARE:.0%} outliers, per pair (true, rotation deg, translation deg, recall, "
        f"admission): {[(n, round(r, 4), round(t, 4), round(c, 4), round(a, 4)) for n, r, t, c, a in rows]}")
    worst = [max(r[1] for r in held), max(r[2] for r in held), min(r[3] for r in held), max(r[4] for r in held)]
    say(f"eval pose recovery over the {len(held)} of {len(rows)} pairs with at least {RECOVERY_MIN_TRUE} true "
        f"correspondences: worst rotation error {worst[0]:.4f} deg, translation {worst[1]:.4f} deg (max "
        f"{RECOVERY_DEG}), inlier recall {worst[2]:.4f} (min {RECOVERY_RECALL_MIN}), outlier admission "
        f"{worst[3]:.4f} (max {RECOVERY_ADMIT_MAX})")
    if (len(held) < len(rows) // 2 or worst[0] >= RECOVERY_DEG or worst[1] >= RECOVERY_DEG
            or worst[2] <= RECOVERY_RECALL_MIN or worst[3] >= RECOVERY_ADMIT_MAX):
        fail("the device pose backend did not recover the pose on every pair it is held on")
    return inputs


@contextlib.contextmanager
def recording_eval(eval_imp, model):
    """Records, for one `evaluate` run, each pair's (indices0, number of
    keypoints, pose error), each matcher call's CUDA events, and the host
    seconds of each pair's device pose and of its whole scoring."""
    rec = {"pairs": [], "matcher": [], "pose_s": 0.0, "score_s": 0.0}
    score, pose, produce = eval_imp._score_pair, eval_imp.device_pose, model.produce_matches

    def produce_timed(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = produce(*a, **k)
        end.record()
        rec["matcher"].append((start, end))
        return out

    def pose_timed(*a, **k):
        t0 = time.perf_counter()
        out = pose(*a, **k)     # ends in a copy to the host
        rec["pose_s"] += time.perf_counter() - t0
        return out

    def score_recorded(info, x0, x1, matches, bucket, pose_errors, *a, **k):
        t0 = time.perf_counter()
        score(info, x0, x1, matches, bucket, pose_errors, *a, **k)
        rec["score_s"] += time.perf_counter() - t0
        rec["pairs"].append((matches.copy(), len(info["x1"]), pose_errors[-1]))

    eval_imp._score_pair, eval_imp.device_pose, model.produce_matches = score_recorded, pose_timed, produce_timed
    try:
        yield rec
    finally:
        eval_imp._score_pair, eval_imp.device_pose = score, pose
        del model.produce_matches


def eval_run(label, eval_imp, model, reader, kernels, want):
    """`evaluate` over the reader with the device pose backend (launch counts
    set to 0 just before, read just after; `want` per batch, the rest 0).
    Prints pairs/s, the split and the metrics; returns the recorded pairs."""
    from impx_torch.data.reader import round_up

    n_batches = -(-len(reader) // EVAL_BATCH)
    for fn in kernels.values():
        fn.launches = 0
    with recording_eval(eval_imp, model) as rec:
        t0 = time.perf_counter()
        res = eval_imp.evaluate(model, reader, EVAL_ERROR_PX, EVAL_CONFIG, EvalArgs())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    expect = {**dict.fromkeys(kernels, 0), **{k: n * n_batches for k, n in want.items()}}
    matcher_ms = [s.elapsed_time(e) for s, e in rec["matcher"]]
    n = len(rec["pairs"])
    say(f"eval {label}: pairs_per_s {n / wall:.2f} over {n} pairs (evaluate {wall:.3f} s, batch {EVAL_BATCH}, "
        f"bucket {round_up(reader.num_kpt, 128)}); matcher {statistics.median(matcher_ms):.3f} ms a batch "
        f"(median of {len(matcher_ms)}, CUDA events); device pose {1e3 * rec['pose_s'] / n:.3f} ms a pair; "
        f"host metrics {1e3 * (rec['score_s'] - rec['pose_s']) / n:.3f} ms a pair; reader, feed and the "
        f"rest {1e3 * (wall - rec['score_s']) / n_batches - statistics.median(matcher_ms):.3f} ms a batch")
    say(f"eval {label} launches over {n_batches} batches: {launches}")
    if launches != expect:
        fail(f"eval {label} did not run through the kernels as expected: {launches}, want {expect}")
    errs = [p[2] for p in rec["pairs"]]
    say(f"eval {label} (random weights, not an accuracy figure): AUC@5/10/20 "
        f"{res['auc'][5]:.2f}/{res['auc'][10]:.2f}/{res['auc'][20]:.2f}, precision {res['precision']:.2f}, "
        f"matching score {res['matching_score']:.2f}; matches a pair {[int((p[0] > -1).sum()) for p in rec['pairs']]}; "
        f"pairs with a pose {sum(e < float('inf') for e in errs)} of {n}")
    if n != len(reader) or not all(e == e for e in errs):
        fail(f"eval {label}: {n} pairs scored of {len(reader)}, or a NaN pose error")
    return rec["pairs"]


def compare_eval_paths(label, kernel_pairs, plain_pairs):
    """indices0 agreement over valid rows (E2E_AGREE_MIN), and equal pose
    errors (POSE_EQUAL_DEG) on every pair whose two match sets are equal:
    both draw from the same per-pair generator."""
    same_rows = sum(int((k[0][:k[1]] == p[0][:p[1]]).sum()) for k, p in zip(kernel_pairs, plain_pairs))
    rows = sum(k[1] for k in kernel_pairs)
    equal_sets = [(k[2], p[2]) for k, p in zip(kernel_pairs, plain_pairs) if np.array_equal(k[0], p[0])]
    diffs = [0.0 if a == b else abs(a - b) for a, b in equal_sets]
    worst = max(diffs, default=0.0)
    say(f"eval {label} kernel vs plain path: indices0 agreement {same_rows / rows:.4f} (min {E2E_AGREE_MIN}) "
        f"over valid rows; {len(equal_sets)} of {len(kernel_pairs)} pairs with equal match sets, their pose "
        f"errors differ by at most {worst:.3e} deg (max {POSE_EQUAL_DEG})")
    if same_rows / rows < E2E_AGREE_MIN or not worst <= POSE_EQUAL_DEG:
        fail(f"eval {label}: the kernel path disagrees with the plain path")


def eval_path(dev, kernels, DGNNS, AdaGMN, MatcherConfig, load_reference_state_dict):
    """The eval CLI's loop (impx_torch.eval.eval_imp.evaluate) at the YFCC eval
    config with the device pose backend: IMP at fp32 (the CLI's default) and
    bf16 on the kernel and the plain path, EIMP mask-only at bf16; the pose
    backend's recovery on true correspondences; one profiled batch of the pose
    stage and of the fp32 matcher."""
    from impx_torch.data.reader import round_up
    from impx_torch.eval import eval_imp
    from impx_torch.eval.evaluator import device_pose, pair_generator
    from impx_torch.models.fast import _eimp_do_pool

    t_phase = time.perf_counter()
    reader = SyntheticReader(EVAL_PAIRS, EVAL_KPT, seed=20)
    recovery_inputs = pose_recovery(dev, reader)
    fp32_model = None
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype=dtype)
        imp_want = {"mha_fused": 2 * cfg.n_layers, "sinkhorn_fused_stats": 1}
        model = carried_model(DGNNS, cfg, dev, reference_layout, load_reference_state_dict)
        kernel_pairs = eval_run(f"IMP {dtype} kernel path", eval_imp, model, reader, kernels, imp_want)
        model.use_kernels = False
        plain_pairs = eval_run(f"IMP {dtype} plain path", eval_imp, model, reader, kernels, {})
        model.use_kernels = True
        compare_eval_paths(f"IMP {dtype}", kernel_pairs, plain_pairs)
        if dtype == "float32":
            fp32_model = model
    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="bfloat16")
    model = carried_model(AdaGMN, cfg, dev, reference_layout, load_reference_state_dict)
    pools = sum(_eimp_do_pool(cfg))   # a pooling iteration's two layers run kernel 4
    eval_run("EIMP mask-only bfloat16 kernel path", eval_imp, model, reader, kernels,
             {"mha_fused": 2 * (cfg.n_layers - pools), "mha_fused_lse": 2 * pools,
              "sinkhorn_fused_stats": cfg.n_layers, "attention_key_mass": 2 * pools})
    del model

    # one profiled batch of the pose stage: device operations a pair, idle share
    profile_calls(f"eval device pose ({EVAL_BATCH} pairs, one call a pair)",
                  lambda a: device_pose(*a[:3], dev, pair_generator(dev, 0, a[3])), recovery_inputs)
    # the fp32 matcher (the CLI's default dtype): kernel 1's fp32 and kernel 2's time a launch
    feeds = []
    for start in range(0, EVAL_BATCH * EVAL_BATCH, EVAL_BATCH):
        batch = [eval_imp._pair_feed_np(reader.run(i % len(reader)), round_up(EVAL_KPT, 128))[0]
                 for i in range(start, start + EVAL_BATCH)]
        feeds.append({k: torch.from_numpy(np.stack([f[k] for f in batch])).to(dev) for k in batch[0]})
    groups = profile_calls(f"eval IMP float32 produce_matches B={EVAL_BATCH} N={round_up(EVAL_KPT, 128)}",
                           lambda d: fp32_model.produce_matches(d, only_last=True, with_scores=False), feeds)
    v0, v1 = feeds[0]["valid0"], feeds[0]["valid1"]
    n = v0.shape[1]
    q = torch.empty((2 * EVAL_BATCH, H, n, D // H), device=dev)
    a_bounds = fp32_bounds(*attention_work(q, torch.cat([v0, v1])))
    s_bound, s_by, _ = sinkhorn_bound(torch.empty((EVAL_BATCH, n, n), device=dev), v0, v1)
    if groups is not None:
        (a_ms, a_n), (s_ms, s_n) = groups[KERNEL_GROUPS[0][0]], groups[KERNEL_GROUPS[4][0]]
        say(f"profile eval IMP float32: kernel 1 (attn_fwd_tf32x3) {a_ms / max(a_n, 1):.4f} ms a launch over "
            f"{a_n:.0f} launches, {bounds_text(a_bounds)}; {F32_ATTN_MS_BEFORE} ms a launch before the 3xTF32 "
            f"redesign; kernel 2 (fp32 dist) {s_ms / max(s_n, 1):.4f} ms a launch over {s_n:.0f}, bound "
            f"{s_bound:.4f} ms ({s_by})")
        say(f"profile eval IMP float32 matcher: {sum(ms for ms, _ in groups.values()):.3f} ms of device time a "
            f"call (the sum of its kernels' times), {a_ms:.3f} of it kernel 1; {F32_MATCHER_MS_BEFORE} ms a call "
            f"before the 3xTF32 redesign")
    say(f"eval phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- the iterative loop
# impx/eval/eval_imp.py's iterative defaults: 4096 minimal sets a checkpoint
# (five-point), matches at 0.1, 25 of them for a pose, a stop at 1.5 degrees
ITER_LAYERS = 15
ITER_HYPOTHESES = 4096
ITER_SERIAL_PAIRS, ITER_EIMP_PAIRS, ITER_CV2_PAIRS = 8, 8, 4
ITER_EIMP_BIN_SCORE = 4.0          # pooling drops keypoints at random weights, matches remain
ITER_SERIAL_DEG = 0.5              # serial vs batched pose, fp32 (matcher sums of another batch shape)
ITER_OPS_RATIO_MAX = 1.5           # device operations of the batched checkpoint solve, P = 4 over P = 1
ITER_PLAIN = ("mha_reference", "mha_lse_reference", "attention_key_mass_reference",
              "attention_key_mass_from_lse_reference")


class IterArgs:
    """evaluate's arguments for the iterative loop, as the CLI gives them."""

    def __init__(self, max_pairs: int, eval_batch: int, checkpoint_backend: str = "jax",
                 use_uncertainty: bool = False):
        self.max_pairs, self.bucket, self.eval_batch, self.pose_backend = max_pairs, -1, eval_batch, "device"
        self.use_iterative, self.use_uncertainty = True, use_uncertainty
        self.checkpoint_backend, self.ransac_hypotheses = checkpoint_backend, ITER_HYPOTHESES


def recording_matcher(BatchedIterativeMatcher):
    """BatchedIterativeMatcher recording, into its class's `rec`, each loop's
    outputs, each checkpoint's indices0, keep mask and poses, each pose
    solve's inputs and generator states, the keep counts after each pool, and
    CUDA events around the layer steps, the score and matches, the pose solve
    and the pooling."""

    class Recorder(BatchedIterativeMatcher):
        rec: dict = {}

        def _timed(self, kind, fn, *a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.rec["events"].setdefault(kind, []).append((start, end))
            return out

        def _loop(self, *a, **k):
            self.rec["batch"] += 1
            self.rec["steps"][self.rec["batch"]] = 0
            out = super()._loop(*a, **k)
            self.rec["loops"].append({k: v.clone() for k, v in out.items()})
            return out

        def _run_cv2(self, *a, **k):
            self.rec["batch"] += 1
            self.rec["steps"][self.rec["batch"]] = 0
            out = super()._run_cv2(*a, **k)
            self.rec["loops"].append({"stopped_at": torch.tensor([out["stopped_at"]])})
            return out

        def _step(self, *a, **k):
            self.rec["steps"][self.rec["batch"]] += 1
            return self._timed("layer steps", super()._step, *a, **k)

        def _match_at(self, ni, desc, keep0, keep1):
            self.ni = ni
            out = self._timed("score and matches", super()._match_at, ni, desc, keep0, keep1)
            self.rec["checkpoints"][(self.rec["batch"], ni)] = (out[1].clone(), keep0.clone())
            return out

        def _solve_pose(self, generators, *a, **k):
            states = [g.get_state() for g in generators]
            out = self._timed("pose solve", super()._solve_pose, generators, *a, **k)
            inputs = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)
            self.rec["solves"][(self.rec["batch"], self.ni)] = (inputs, states, out["R"].clone(), out["t"].clone())
            return out

        def _check(self, *a, **k):
            self.rec["checks"] += 1
            out = super()._check(*a, **k)
            self.rec["has_pose"].append(out[0]["has_pose"].clone())
            return out

        def _pool(self, *a, **k):
            out = self._timed("pooling", super()._pool, *a, **k)
            self.rec["keep"].append(torch.stack([out[0].sum(1), out[1].sum(1)]))
            return out

    return Recorder


def new_record() -> dict:
    return {"batch": -1, "steps": {}, "events": {}, "loops": [], "checkpoints": {}, "solves": {}, "checks": 0,
            "keep": [], "has_pose": [], "pairs": []}


def checkpoint_syncs(IterativeMatcher, model, feed, norm_thresh, generator) -> list:
    """The synchronising operations (torch.cuda.set_sync_debug_mode) of one
    pair's loop: inside each checkpoint, a list of the Python stack (its last
    frames) at which each warning surfaced; and the count outside them (the
    loop's one read a checkpoint, its input copies and its output). Run after
    the loop has run once in the process, so that one-time set-up is done."""
    import traceback
    import warnings

    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1] if "warnings" not in f.filename][-5:]
            sites[-1].append(" <- ".join(f"{f.filename.split('/')[-1]}:{f.lineno} {f.name}" for f in reversed(frames)))

    class Counting(IterativeMatcher):
        def _check(self, *a, **k):
            sites.append([])
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                return super()._check(*a, **k)

    # the mode is switched outside the checkpoints: the switch to "warn" can
    # surface a warning of its own before the first one
    with warnings.catch_warnings(record=True) as outside:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            Counting(model, norm_thresh=norm_thresh, num_hypotheses=ITER_HYPOTHESES).run(feed, generator)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites, sum("synchroniz" in str(w.message) for w in outside)


def iterative_run(label, eval_imp, model, reader, kernels, args, Recorder, ka):
    """evaluate with --use_iterative over the reader (launch counts set to 0
    just before, read just after; the plain bodies counted), through the
    recording matcher. Checks the launches against the layer steps the loop
    ran (kernel 1 on every layer step, kernels 4 and 6 on the checkpoint
    layers and their pools under uncertainty, nothing else), the steps
    against each batch's last stop iteration, no plain body on the kernel
    path, and a finite pose error for every pair. Prints pairs/s, the stop
    iterations, the split of a checkpoint and the metrics; returns the record."""
    import collections

    rec = new_record()
    Recorder.rec = rec
    score, matcher_cls = eval_imp._score_pair, eval_imp.BatchedIterativeMatcher

    def score_recorded(info, x0, x1, matches, bucket, pose_errors, *a, **k):
        score(info, x0, x1, matches, bucket, pose_errors, *a, **k)
        rec["pairs"].append((matches.copy(), len(info["x1"]), pose_errors[-1]))

    for fn in kernels.values():
        fn.launches = 0
    eval_imp._score_pair, eval_imp.BatchedIterativeMatcher = score_recorded, Recorder
    try:
        with counting_plain_bodies(ka, ITER_PLAIN) as plain_calls:
            t0 = time.perf_counter()
            res = eval_imp.evaluate(model, reader, EVAL_ERROR_PX, EVAL_CONFIG, args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        eval_imp._score_pair, eval_imp.BatchedIterativeMatcher = score, matcher_cls
    launches = {name: fn.launches for name, fn in kernels.items()}
    steps = sum(rec["steps"].values())
    pools = len(rec["keep"])
    checks = rec["checks"] if args.checkpoint_backend != "cv2" else len(rec["checkpoints"])
    n = len(rec["pairs"])
    stops = [int(x) for loop in rec["loops"] for x in loop["stopped_at"].tolist()]
    last = [max(loop["stopped_at"].tolist()) for loop in rec["loops"]]
    ms = {kind: sum(s.elapsed_time(e) for s, e in ev) for kind, ev in rec["events"].items()}
    say(f"iterative {label}: pairs_per_s {n / wall:.2f} over {n} pairs (evaluate {wall:.3f} s, batch "
        f"{args.eval_batch}, {len(rec['loops'])} loops, {steps} layer steps, {checks} checkpoints); stop "
        f"iterations mean {np.mean(stops[:n]):.2f}, histogram {dict(sorted(collections.Counter(stops[:n]).items()))}")
    say(f"iterative {label}: ms a checkpoint (CUDA events, summed over the run / {max(checks, 1)} checkpoints): "
        + ", ".join(f"{kind} {ms[kind] / max(checks, 1):.3f}" for kind in
                    ("layer steps", "score and matches", "pose solve", "pooling") if kind in ms)
        + (f"; keep counts after the last pool {rec['keep'][-1].tolist()}" if rec["keep"] else ""))
    say(f"iterative {label} launches: {launches}; plain bodies called {plain_calls}")
    if model.use_kernels:
        want = dict.fromkeys(kernels, 0)
        lse_layers = 2 * checks if args.use_uncertainty else 0
        want.update(mha_fused=2 * steps - lse_layers, mha_fused_lse=lse_layers,
                    attention_key_mass=2 * pools if args.use_uncertainty else 0)
        if launches != want or any(plain_calls.values()):
            fail(f"iterative {label} did not run through the kernels as expected: {launches}, want {want}, "
                 f"plain bodies {plain_calls}")
    if [rec["steps"][b] for b in sorted(rec["steps"])] != last:
        fail(f"iterative {label}: layer steps a loop {list(rec['steps'].values())} are not the last stop "
             f"iterations {last}")
    errs = [p[2] for p in rec["pairs"]]
    say(f"iterative {label} (random weights, not an accuracy figure): AUC@5/10/20 "
        f"{res['auc'][5]:.2f}/{res['auc'][10]:.2f}/{res['auc'][20]:.2f}, precision {res['precision']:.2f}, "
        f"matching score {res['matching_score']:.2f}, mean_stop_iteration {res['mean_stop_iteration']:.2f}; "
        f"matches a pair {[int((p[0] > -1).sum()) for p in rec['pairs']]}")
    if n != min(args.max_pairs, len(reader)) or not all(e == e for e in errs):
        fail(f"iterative {label}: {n} pairs scored, or a NaN pose error")
    rec.update(launches=launches, wall=wall, stops=stops[:n], ms=ms)
    return rec


def compare_iterative(label, kernel, plain, replay, max_replays: int = 4):
    """Kernel path against plain path of one loop: indices0 agreement over the
    valid rows of every checkpoint both reached (E2E_AGREE_MIN); at up to
    max_replays checkpoints where both handed the solver equal match sets,
    the checkpoint solve run again on the same inputs with each pair's
    generator restored to its state there (`replay`), which must give the
    recorded poses bit for bit; and, printed, how far the two paths' poses
    differ there (their match scores differ by the matcher's rounding, which
    moves the score-weighted draws). Returns the replays."""
    agree = []
    for key, (idx, keep) in kernel["checkpoints"].items():
        if key in plain["checkpoints"]:
            pidx = plain["checkpoints"][key][0]
            agree.append(((idx == pidx) & keep).sum().item() / max(keep.sum().item(), 1))
    replays, exact, cross = 0, True, 0.0
    for key, (inputs, states, R, t) in kernel["solves"].items():
        if key not in plain["solves"] or replays >= max_replays:
            continue
        _, _, pR, pt = plain["solves"][key]
        same = (inputs[2] == plain["solves"][key][0][2]).all(1)
        if not bool(same.all()):
            continue
        out = replay(inputs, states)
        exact &= torch.equal(out["R"], R) and torch.equal(out["t"], t)
        cross = max(cross, pose_diff64(R, t, pR, pt).max().item())
        replays += 1
    say(f"iterative {label} kernel vs plain path: indices0 agreement over valid rows, per checkpoint, min "
        f"{min(agree, default=1.0):.4f} mean {np.mean(agree) if agree else 1.0:.4f} over {len(agree)} checkpoints "
        f"(min {E2E_AGREE_MIN}); {replays} checkpoint solves with equal match sets replayed from the restored "
        f"generators: poses equal bit for bit {exact}; the two paths' poses there differ by at most {cross:.3e} deg")
    if min(agree, default=1.0) < E2E_AGREE_MIN or not exact:
        fail(f"iterative {label}: the kernel path disagrees with the plain path, or a replayed solve differs")
    return replays


def pose_diff64(R1, t1, R2, t2):
    """The loop's pose difference in degrees, in float64: in float32 its
    arccos reads about 0.06 degrees between equal poses."""
    from impx_torch.eval.iterative import _pose_diff_deg

    return _pose_diff_deg(R1.double(), t1.double(), R2.double(), t2.double())


def checkpoint_recovery(dev, reader):
    """The checkpoint solver (estimate_pose_from_matches, four pairs a batched
    call, ITER_HYPOTHESES minimal sets) on each pair's true correspondences
    plus random pairings of outlier keypoints (RECOVERY_OUTLIER_SHARE), as a
    matcher hands them over with random scores; held at phase 16's limits on
    every pair with at least RECOVERY_MIN_TRUE true correspondences."""
    from impx_torch.eval.evaluator import pair_generator
    from impx_torch.geometry.pose import angle_error_mat, angle_error_vec
    from impx_torch.ransac.pose_solver import _norm_threshold, estimate_pose_from_matches, prior_essential

    rs = np.random.RandomState(22)
    feeds = []
    for i, p in enumerate(reader.pairs):
        gt, n0, n1 = p["gt_matches"], min(len(p["kpt1"]), EVAL_KPT), min(len(p["kpt2"]), EVAL_KPT)
        gt = gt[(gt[:, 0] < n0) & (gt[:, 1] < n1)]
        n_out = int(round(len(gt) * RECOVERY_OUTLIER_SHARE / (1 - RECOVERY_OUTLIER_SHARE)))
        out0 = rs.choice(np.setdiff1d(np.arange(n0), gt[:, 0]), n_out, replace=False)
        idx = np.full(EVAL_KPT, -1)
        idx[gt[:, 0]] = gt[:, 1]
        idx[out0] = rs.choice(np.setdiff1d(np.arange(n1), gt[:, 1]), n_out)
        norm = lambda x, K: ((x[:EVAL_KPT, :2] - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])).astype(np.float32)  # noqa: E731
        pad = lambda x: np.pad(x, ((0, EVAL_KPT - len(x)), (0, 0)))  # noqa: E731
        feeds.append((pad(norm(p["kpt1"], p["K1"])), pad(norm(p["kpt2"], p["K2"])), idx,
                      np.where(idx > -1, rs.uniform(0.2, 1.0, EVAL_KPT), 0.0).astype(np.float32),
                      _norm_threshold(EVAL_ERROR_PX, p["K1"], p["K2"]), len(gt), gt[:, 0], out0))
    rows = []
    for s in range(0, len(feeds), EVAL_BATCH):
        part = feeds[s:s + EVAL_BATCH]
        st = lambda k: torch.tensor(np.stack([f[k] for f in part]), device=dev)  # noqa: E731
        P = len(part)
        eye = torch.eye(3, device=dev).expand(P, 3, 3)
        out = estimate_pose_from_matches([pair_generator(dev, 0, s + i) for i in range(P)], st(0), st(1), st(2),
                                         st(3), torch.tensor([f[4] for f in part], device=dev),
                                         num_hypotheses=ITER_HYPOTHESES,
                                         E_init=prior_essential(eye, torch.zeros(P, 3, device=dev),
                                                                torch.zeros(P, dtype=torch.bool, device=dev)))
        for i, f in enumerate(part):
            p = reader.pairs[s + i]
            err_R = float(angle_error_mat(torch.tensor(p["R"], dtype=torch.float32), out["R"][i].cpu()))
            err_t = float(angle_error_vec(torch.tensor(p["T"], dtype=torch.float32), out["t"][i].cpu()))
            inl = out["inliers"][i].cpu().numpy()
            rows.append((f[5], err_R, err_t, inl[f[6]].mean(), inl[f[7]].mean()))
    held = [r for r in rows if r[0] >= RECOVERY_MIN_TRUE]
    worst = [max(r[1] for r in held), max(r[2] for r in held), min(r[3] for r in held), max(r[4] for r in held)]
    say(f"iterative checkpoint solver recovery, {ITER_HYPOTHESES} minimal sets, threshold {EVAL_ERROR_PX} px, "
        f"per pair (true, rotation deg, translation deg, recall, admission): "
        f"{[(n, round(r, 4), round(t, 4), round(c, 4), round(a, 4)) for n, r, t, c, a in rows]}")
    say(f"iterative checkpoint solver recovery over the {len(held)} of {len(rows)} pairs with at least "
        f"{RECOVERY_MIN_TRUE} true correspondences: worst rotation {worst[0]:.4f} deg, translation {worst[1]:.4f} "
        f"deg (max {RECOVERY_DEG}), recall {worst[2]:.4f} (min {RECOVERY_RECALL_MIN}), admission {worst[3]:.4f} "
        f"(max {RECOVERY_ADMIT_MAX})")
    if (len(held) < len(rows) // 2 or worst[0] >= RECOVERY_DEG or worst[1] >= RECOVERY_DEG
            or worst[2] <= RECOVERY_RECALL_MIN or worst[3] >= RECOVERY_ADMIT_MAX):
        fail("the checkpoint solver did not recover the pose on every pair it is held on")


def iterative_path(dev, kernels, ka, DGNNS, AdaGMN, MatcherConfig, load_reference_state_dict) -> dict:
    """Phase 17: the iterative match-pose loop with early stopping through the
    eval CLI's evaluate (IterativeMatcher.run pair by pair,
    BatchedIterativeMatcher.run_batch, the cv2 checkpoints) at
    eval_config('spp', 15), on the kernel and the plain path. Returns each
    kernel's launches over the phase's kernel-path runs."""
    from impx_torch.data.reader import round_up
    from impx_torch.eval import eval_imp
    from impx_torch.eval.evaluator import pair_generator
    from impx_torch.eval.iterative import BatchedIterativeMatcher, IterativeMatcher

    t_phase = time.perf_counter()
    Recorder = recording_matcher(BatchedIterativeMatcher)
    reader = SyntheticReader(EVAL_PAIRS, EVAL_KPT, seed=20)
    checkpoint_recovery(dev, reader)
    total = dict.fromkeys(kernels, 0)
    base = MatcherConfig.eval_config("spp", ITER_LAYERS)
    models = {dt: carried_model(DGNNS, dataclasses.replace(base, compute_dtype=dt), dev, reference_layout,
                                load_reference_state_dict) for dt in ("float32", "bfloat16")}
    runs = {}

    def replay(inputs, states):
        """The checkpoint solve again on recorded inputs, each pair's generator
        restored to its recorded state."""
        gens = [torch.Generator(device=dev) for _ in states]
        for g, state in zip(gens, states):
            g.set_state(state)
        solver = IterativeMatcher(models["float32"], norm_thresh=0.0, num_hypotheses=ITER_HYPOTHESES)
        return solver._solve_pose(gens, *inputs)

    def both(label, model, args):
        kernel = iterative_run(f"{label} kernel path", eval_imp, model, reader, kernels, args, Recorder, ka)
        for k, v in kernel["launches"].items():
            total[k] += v
        model.use_kernels = False
        plain = iterative_run(f"{label} plain path", eval_imp, model, reader, kernels, args, Recorder, ka)
        model.use_kernels = True
        runs[label] = (kernel, plain)
        return kernel, plain

    # serial, device checkpoints, fp32 (the CLI's default dtype)
    serial, serial_plain = both("IMP float32 serial", models["float32"], IterArgs(ITER_SERIAL_PAIRS, 1))
    bucket = round_up(EVAL_KPT, 128)
    feed, _, _, nt = eval_imp._iterative_feed(reader.run(0), bucket, EVAL_ERROR_PX, False)
    feed = {k: (v[None] if k in eval_imp.MATCHER_FEED else v) for k, v in feed.items()}
    sites, outside = checkpoint_syncs(IterativeMatcher, models["float32"], feed, nt, pair_generator(dev, 0, 0))
    syncs = [len(c) for c in sites]
    say(f"iterative IMP float32 pair 0: synchronising operations inside each checkpoint "
        f"(torch.cuda.set_sync_debug_mode) {syncs}; {outside} outside them (the mode switch, the input "
        f"copies, one read a checkpoint, the output)")
    for c in sum(sites, []):
        say(f"iterative synchronising operation: {c}")
    replays = compare_iterative("IMP float32 serial", serial, serial_plain, replay)
    for dt in ("float32", "bfloat16"):
        kernel, plain = both(f"IMP {dt} batched", models[dt], IterArgs(EVAL_PAIRS, EVAL_BATCH))
        replays += compare_iterative(f"IMP {dt} batched", kernel, plain, replay)
    if not replays:
        fail("no checkpoint saw equal match sets on both paths: the replay check did not bite")
    # serial against batched at fp32: the same stop iteration and pose a pair
    batched = runs["IMP float32 batched"][0]
    sR = torch.cat([loop["R"] for loop in serial["loops"]])
    st = torch.cat([loop["t"] for loop in serial["loops"]])
    bR = torch.cat([loop["R"] for loop in batched["loops"]])[:len(sR)]
    bt = torch.cat([loop["t"] for loop in batched["loops"]])[:len(st)]
    diff = pose_diff64(sR, st, bR, bt)
    say(f"iterative IMP float32 serial vs batched: stop iterations {serial['stops']} and "
        f"{batched['stops'][:len(serial['stops'])]}; poses differ by at most {diff.max().item():.3e} deg "
        f"(max {ITER_SERIAL_DEG})")
    if serial["stops"] != batched["stops"][:len(serial["stops"])] or diff.max().item() > ITER_SERIAL_DEG:
        fail("the serial and the batched loop disagree")
    s_ms = [s.elapsed_time(e) for s, e in serial["events"]["pose solve"]]
    b_ms = [s.elapsed_time(e) for s, e in batched["events"]["pose solve"]]
    say(f"iterative checkpoint solve (CUDA events, median): P = 1 {statistics.median(s_ms):.3f} ms, P = "
        f"{EVAL_BATCH} {statistics.median(b_ms):.3f} ms against P x serial {EVAL_BATCH * statistics.median(s_ms):.3f} ms")

    # EIMP with uncertainty: pools after each checkpoint, kernel 4's row lse to kernel 6
    eimp = carried_model(AdaGMN, base, dev, reference_layout, load_reference_state_dict,
                         randomize=lambda m: m.bin_score.data.fill_(ITER_EIMP_BIN_SCORE))
    kernel, plain = both("EIMP float32 uncertainty batched", eimp,
                         IterArgs(ITER_EIMP_PAIRS, EVAL_BATCH, use_uncertainty=True))
    compare_iterative("EIMP float32 uncertainty batched", kernel, plain, replay)
    if not kernel["launches"]["attention_key_mass"]:
        fail("the uncertainty loop never pooled")
    # the reference protocol's checkpoints: host cv2 on pixel coordinates
    both("IMP float32 cv2 checkpoints", models["float32"], IterArgs(ITER_CV2_PAIRS, 1, checkpoint_backend="cv2"))
    compare_iterative("IMP float32 cv2 checkpoints", *runs["IMP float32 cv2 checkpoints"], replay)

    # early exit: pose_stop_deg=180 stops at the second checkpoint with a pose
    model = models["float32"]
    for i in range(2):
        feed, _, _, nt = eval_imp._iterative_feed(reader.run(i), bucket, EVAL_ERROR_PX, False)
        feed = {k: (v[None] if k in eval_imp.MATCHER_FEED else v) for k, v in feed.items()}
        Recorder.rec = new_record()
        m = Recorder(model, norm_thresh=nt, num_hypotheses=ITER_HYPOTHESES, pose_stop_deg=180.0)
        for fn in kernels.values():
            fn.launches = 0
        out = m.run(feed, pair_generator(dev, 0, i))
        torch.cuda.synchronize()
        with_pose = [ni for ni, hp in zip(m.valid_its, Recorder.rec["has_pose"]) if bool(hp[0])]
        want = with_pose[1] + 1 if len(with_pose) > 1 else model.config.n_layers
        say(f"iterative early exit (pose_stop_deg 180), pair {i}: stopped_at {out['stopped_at']} (checkpoints with a "
            f"pose {with_pose}), mha_fused launches {mha_fused_launches(kernels)} for {out['stopped_at']} of "
            f"{model.config.n_layers} iterations")
        if out["stopped_at"] != want or mha_fused_launches(kernels) != 2 * out["stopped_at"] or want >= ITER_LAYERS:
            fail("early exit did not stop at the second checkpoint with a pose, or ran layers after it")

    # device operations of one checkpoint solve, P = 1 and P = EVAL_BATCH
    inputs = next(iter(batched["solves"].values()))[0]
    x0n, x1n, idx0, ms0, thr, E_init = inputs[:6]
    solve = lambda P: lambda _: IterativeMatcher._solve_pose(  # noqa: E731
        m, [pair_generator(dev, 0, i) for i in range(P)], x0n[:P], x1n[:P], idx0[:P], ms0[:P], thr[:P], E_init[:P])
    ops = {}
    for P in (1, EVAL_BATCH):
        groups = profile_calls(f"iterative checkpoint solve P={P} ({ITER_HYPOTHESES} minimal sets a pair)",
                               solve(P), [None, None])
        ops[P] = None if groups is None else sum(n for _, n in groups.values())
    if ops[1] is not None:
        say(f"iterative checkpoint solve: {ops[1]:.0f} device operations at P = 1, {ops[EVAL_BATCH]:.0f} at "
            f"P = {EVAL_BATCH} (ratio {ops[EVAL_BATCH] / ops[1]:.3f}, max {ITER_OPS_RATIO_MAX})")
        if ops[EVAL_BATCH] > ITER_OPS_RATIO_MAX * ops[1]:
            fail("the batched checkpoint solve issues more device operations than one pair's times "
                 f"{ITER_OPS_RATIO_MAX}")
    # the profiler's device launches of kernels 1 and 4, a pair and a batch, against the wrappers' counts
    feeds = []
    for i in range(EVAL_BATCH):
        f, _, _, nt = eval_imp._iterative_feed(reader.run(i), bucket, EVAL_ERROR_PX, False)
        feeds.append(f)
    batch = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    pair = {k: (v[:1] if k in eval_imp.MATCHER_FEED else v[0]) for k, v in batch.items()}
    gens = lambda n: [pair_generator(dev, 0, i) for i in range(n)]  # noqa: E731
    m = BatchedIterativeMatcher(model, norm_thresh=nt, num_hypotheses=ITER_HYPOTHESES)
    profile_launches("IMP float32 run, one pair", kernels, lambda _: m.run(pair, gens(1)[0]))
    profile_launches(f"IMP float32 run_batch B={EVAL_BATCH}", kernels,
                     lambda _: m.run_batch(batch, gens(EVAL_BATCH), [nt] * EVAL_BATCH))
    m = BatchedIterativeMatcher(eimp, norm_thresh=nt, num_hypotheses=ITER_HYPOTHESES, with_uncertainty=True)
    profile_launches(f"EIMP float32 uncertainty run_batch B={EVAL_BATCH}", kernels,
                     lambda _: m.run_batch(batch, gens(EVAL_BATCH), [nt] * EVAL_BATCH))
    say(f"iterative phase {time.perf_counter() - t_phase:.1f} s; kernel launches over its kernel-path runs {total}")
    if any(syncs):
        fail("a checkpoint synchronises with the host")
    return total


def mha_fused_launches(kernels) -> int:
    return kernels["mha_fused"].launches


def profile_launches(label, kernels, call):
    """One profiled call (after profile_calls' warm-up call): the device
    launches of the attention group (kernels 1 and 4) must equal its
    wrappers' launches a call; the mass group's are printed a wrapper call."""
    for fn in kernels.values():
        fn.launches = 0
    groups = profile_calls(f"iterative {label}", call, [None])
    if groups is None:
        return
    wrapped = (kernels["mha_fused"].launches + kernels["mha_fused_lse"].launches) / 2  # warm-up and profiled
    device_n = groups[KERNEL_GROUPS[0][0]][1]
    (a_ms, _), (m_ms, m_n) = groups[KERNEL_GROUPS[0][0]], groups[KERNEL_GROUPS[5][0]]
    say(f"profile iterative {label}: kernels 1 and 4 {device_n:.0f} device launches against {wrapped:.0f} wrapper "
        f"launches a call, {a_ms / max(device_n, 1):.4f} ms a launch; kernel 6 {m_n:.0f} device launches over "
        f"{kernels['attention_key_mass'].launches / 2:.0f} wrapper calls"
        + (f", {m_ms / m_n:.4f} ms a launch ({F32_MASS_MS_BEFORE} before the 3xTF32 redesign, fp32)" if m_n else ""))
    if device_n != wrapped:
        fail(f"iterative {label}: the profiler's kernel 1 and 4 launches differ from the wrappers' count")


# ---------------------------------------------------------------- training kernels
def work_pairs(q, mask) -> float:
    """(query, key) pairs the attention backward needs: every query against
    each batch's valid keys, or against all Nk keys where none is valid (a
    fully masked row spreads its weight over every key); a masked key of a
    batch with valid keys has p = 0 exactly."""
    b, h, nq, _ = q.shape
    valid = mask.sum(1).double()
    keys = torch.where(valid == 0, torch.full_like(valid, mask.shape[1]), valid)
    return h * nq * keys.sum().item()


def training_kernel_bounds(q, mask) -> dict:
    """Least time of each training kernel at these inputs: (ms, what bounds it).
    Kernel 4: QK^T and P.V in the input dtype (4 flops a pair and dh) and its
    bytes (q, o and the valid k, v rows, the lse). Kernel 3: QK^T and dp =
    do.v^T take input-dtype values (4 flops); dv, dq and dk have one fp32
    factor (p or ds) and one input-dtype factor. At bf16 the card does those
    at the precision the kernel keeps as two bf16 products each (the fp32
    factor split into hi + lo), 12 flops, all 16 at the bf16 tensor-core
    rate; at fp32 all 10 at the fp32 rate. "mha_bwd_fma_rate" keeps the
    bound that counted the three fp32-factor products at the fp32 FMA rate
    (6 flops), printed once for the record. Against q, k, v, do read and dq,
    dk, dv written. Kernel 5: five products in the input dtype (10 flops a
    pair and dh), against q, k, v, o, do, lse read and dq, dk, dv written."""
    b, h, nq, dh = q.shape
    pairs = work_pairs(q, mask)
    bf16 = q.dtype == torch.bfloat16
    peak = PEAK_BF16 if bf16 else PEAK_FP32
    row = q.element_size() * h * nq * dh                 # one [H, Nq, dh] tensor of one batch
    nbytes = {"mha_fused_lse": 2 * b * row + 2 * pairs / nq * dh * q.element_size() + 4 * b * h * nq,
              "mha_bwd": 7 * b * row, "mha_bwd_fma_rate": 7 * b * row,
              "mha_bwd_from_lse": 8 * b * row + 4 * b * h * nq}
    t_ops = {"mha_fused_lse": 4 * dh * pairs / peak,
             "mha_bwd": (16 if bf16 else 10) * dh * pairs / peak,
             "mha_bwd_fma_rate": 6 * dh * pairs / PEAK_FP32 + 4 * dh * pairs / peak,
             "mha_bwd_from_lse": 10 * dh * pairs / peak}
    out = {}
    for name, t in t_ops.items():
        t_bytes = nbytes[name] / HBM_BYTES_PER_S
        out[name] = (1e3 * max(t, t_bytes), "operations" if t >= t_bytes else "bytes")
    return out


def training_inputs(gen, dev, dtype, b=2 * TB, h=H, n=TN, dh=D // H, nk=None):
    """q, k, v, do and a key mask with up to 100 padded keys of 1024 (up to
    a third at small sizes); the last batch's keys all masked. nk: the key
    count (n when None)."""
    nk = nk or n
    q, k, v, do = (torch.randn((b, h, x, dh), generator=gen).to(dev, dtype) for x in (n, nk, nk, n))
    mask = torch.arange(nk)[None] < padded_counts(gen, b, nk, max(nk - 100, 2 * nk // 3))[:, None]
    mask[-1] = False
    return q, k, v, mask.to(dev), do


def rel_l2_per_batch(a, r) -> torch.Tensor:
    """||a_b - r_b|| / ||r_b|| for each batch b, in fp32."""
    diff = (a.float() - r.float()).flatten(1).norm(dim=1)
    return diff / r.float().flatten(1).norm(dim=1)


# the training kernels' checks: bf16 at the training shape; fp32 at the
# training shape, a ragged one and one at dh = 16
TRAIN_CHECK_SHAPES = ((torch.bfloat16, dict()), (torch.float32, dict()),
                      (torch.float32, dict(b=3, h=2, n=333, dh=32)), (torch.float32, dict(b=3, h=2, n=250, dh=16)))


def check_training_kernels(dev, ka, shapes=TRAIN_CHECK_SHAPES) -> dict:
    """Kernels 4, 3 and 5 against their plain versions at `shapes`:
    o, dq, dk and dv by the relative L2 error of each batch (the fully masked
    batch on a line of its own), the lse elementwise; the backwards twice,
    for the same bits. Prints every check before failing on any. Returns
    each kernel's max_abs_err at the training shape, bf16 under its name and
    fp32 under (name, torch.float32)."""
    gen = torch.Generator().manual_seed(10)
    errs, failures = {}, []
    for dtype, shape in shapes:
        q, k, v, mask, do = training_inputs(gen, dev, dtype, **shape)
        o, lse = ka.mha_fused_lse(q, k, v, mask)
        g3, g3b = ka.mha_bwd(q, k, v, mask, do), ka.mha_bwd(q, k, v, mask, do)
        g5, g5b = (ka.mha_bwd_from_lse(q, k, v, mask, lse, o, do) for _ in range(2))
        torch.cuda.synchronize()
        ro, rlse = ka.mha_lse_reference(q, k, v, mask)
        checks = [("mha_fused_lse", "o", o, ro, True, FWD_O_REL_L2[dtype])]
        for name, got, again, ref in (
                ("mha_bwd", g3, g3b, ka.mha_bwd_reference(q, k, v, mask, do)),
                ("mha_bwd_from_lse", g5, g5b, ka.mha_bwd_from_lse_reference(q, k, v, mask, lse, o, do))):
            for part, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
                checks.append((name, part, a, r, torch.equal(a, a2), TRAIN_REL_L2[dtype]))
        where = f"{list(q.shape)}{'' if k.shape == q.shape else f' x {k.shape[2]} keys'} {str(dtype)[6:]}"
        for name, part, a, r, same, limit in checks:
            rel = rel_l2_per_batch(a, r)
            err = (a.float() - r.float()).abs().max().item()
            finite = bool(torch.isfinite(a.float()).all())
            say(f"check {name} {part} {where}: relative L2 a batch, largest {rel[:-1].max().item():.3e} "
                f"over the batches with valid keys (max {limit:g}); max_abs_err {err:.3e}; finite {finite}"
                + ("" if name == "mha_fused_lse" else f"; second run bitwise equal {same}"))
            say(f"check {name} {part} {where} fully masked batch: relative L2 {rel[-1].item():.3e} (max {limit:g})")
            if not finite or not same or not bool((rel <= limit).all()):
                failures.append(f"{name} {part} at {where}")
            if not shape:
                key = name if dtype == torch.bfloat16 else (name, dtype)
                errs[key] = max(errs.get(key, 0.0), err)
        lse_err = (lse - rlse).abs()
        lse_bad = (lse_err > FWD_LSE_TOL + FWD_LSE_TOL * rlse.abs()).sum().item()
        masked_lse = bool((lse[-1] == -1e30).all())
        say(f"check mha_fused_lse lse {where}: max_abs_err {lse_err.max().item():.3e} (tol atol=rtol="
            f"{FWD_LSE_TOL:g}), out of tolerance {lse_bad}; the fully masked batch's lse is -1e30 "
            f"exactly: {masked_lse}")
        if lse_bad or not masked_lse:
            failures.append(f"mha_fused_lse lse at {where}")
        del q, k, v, do, o, lse, g3, g3b, g5, g5b, ro, rlse, checks
    if failures:
        fail(f"training kernels disagree with their plain versions or themselves: {failures}")
    return errs


def time_training_kernels(dev, ka, errs, launches) -> list:
    gen = torch.Generator().manual_seed(11)
    ins = [training_inputs(gen, dev, torch.bfloat16) for _ in range(3)]
    saved = [ka.mha_fused_lse(q, k, v, m) for q, k, v, m, _ in ins]
    with_lse = [(q, k, v, m, lse, o, do) for (q, k, v, m, do), (o, lse) in zip(ins, saved)]
    fwd = [x[:4] for x in ins]
    t = {"mha_fused_lse": (cuda_ms(ka.mha_fused_lse, fwd), cuda_ms(ka.mha_lse_reference, fwd)),
         "mha_bwd": (cuda_ms(ka.mha_bwd, ins), cuda_ms(ka.mha_bwd_reference, ins)),
         "mha_bwd_from_lse": (cuda_ms(ka.mha_bwd_from_lse, with_lse),
                              cuda_ms(ka.mha_bwd_from_lse_reference, with_lse))}
    # the library yardstick: scaled_dot_product_attention with a bool mask,
    # its forward for kernel 4 and its backward for kernels 3 and 5
    sdpa = lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=m[:, None, None, :])
    lib_fwd = cuda_ms(sdpa, fwd)
    say(f"time mha_fused_lse queued: {queued_ms(ka.mha_fused_lse, fwd):.4f} ms a call, 20 calls back to "
        f"back (device time); sdpa forward {queued_ms(sdpa, fwd):.4f}")
    graphs = []
    for q, k, v, m, do in ins:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        graphs.append((sdpa(*leaves, m), leaves, do))
    lib_bwd = cuda_ms(lambda out, leaves, do: torch.autograd.grad(out, leaves, do, retain_graph=True), graphs)
    library = {"mha_fused_lse": lib_fwd, "mha_bwd": lib_bwd, "mha_bwd_from_lse": lib_bwd}
    bounds = training_kernel_bounds(ins[0][0], ins[0][3])
    rows = []
    line = {"mha_fused_lse": "impx/ops/pallas/attention.py:245", "mha_bwd": "impx/ops/pallas/attention.py:137",
            "mha_bwd_from_lse": "impx/ops/pallas/attention.py:336"}
    source = {"mha_fused_lse": "impx_torch/csrc/attention.cu", "mha_bwd": "impx_torch/csrc/attention_bwd.cu",
              "mha_bwd_from_lse": "impx_torch/csrc/attention_bwd.cu"}
    for name, (k_ms, p_ms) in t.items():
        b_ms, b_by = bounds[name]
        say(f"time {name} {list(ins[0][0].shape)} bf16: ms {k_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
            f"launches {launches[name]} a training step plain_ms {p_ms:.4f} library_ms {library[name]:.4f} "
            f"(sdpa {'forward' if name == 'mha_fused_lse' else 'backward'}, bool mask)")
        if name == "mha_bwd":
            say(f"time mha_bwd: the bound that counted dv, dq and dk at the fp32 FMA rate was "
                f"{bounds['mha_bwd_fma_rate'][0]:.4f} ms; the bound above counts them as bf16 hi + lo "
                f"products on the tensor cores, the precision the kernel keeps")
        rows.append({"name": name, "route": "cuda", "source": source[name], "replaces": line[name],
                     "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": library[name]})
    return rows


def time_fp32_backward(dev, ka, errs, launches) -> dict:
    """Kernels 3 and 5 at fp32 at the training shape [32, 4, 1024, 64]: one
    call between two events, 20 queued, the 3xTF32 and FMA bounds of their
    five products (10 flops a valid pair and dh, one exponential a pair, as
    training_kernel_bounds counts the pairs and bytes), the plain version,
    scaled_dot_product_attention's fp32 backward with the bool mask (its
    backend named), and the FMA design's time before the redesign. Returns
    each kernel's JSON "fp32" entry."""
    gen = torch.Generator().manual_seed(14)
    ins = [training_inputs(gen, dev, torch.float32) for _ in range(3)]
    saved = [ka.mha_fused_lse(q, k, v, m) for q, k, v, m, _ in ins]
    with_lse = [(q, k, v, m, lse, o, do) for (q, k, v, m, do), (o, lse) in zip(ins, saved)]
    sdpa = lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=m[:, None, None, :])
    graphs = []
    for q, k, v, m, do in ins:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        graphs.append((sdpa(*leaves, m), leaves, do))
    lib = lambda out, leaves, do: torch.autograd.grad(out, leaves, do, retain_graph=True)
    backend = sdpa_backend(device_kernels(lib, graphs[0]))
    lib_ms, lib_queued = cuda_ms(lib, graphs), queued_ms(lib, graphs)
    q, mask = ins[0][0], ins[0][3]
    b, h, nq, dh = q.shape
    pairs = work_pairs(q, mask)
    row = q.element_size() * h * nq * dh
    nbytes = {"mha_bwd": 7 * b * row, "mha_bwd_from_lse": 8 * b * row + 4 * b * h * nq}
    say(f"time sdpa backward {list(q.shape)} fp32 bool mask: {backend} backend; ms {lib_ms:.4f} queued_ms "
        f"{lib_queued:.4f}; tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")
    rows = {}
    for name, fn, plain, args in (("mha_bwd", ka.mha_bwd, ka.mha_bwd_reference, ins),
                                  ("mha_bwd_from_lse", ka.mha_bwd_from_lse, ka.mha_bwd_from_lse_reference,
                                   with_lse)):
        bnd = fp32_bounds(10.0 * dh * pairs, pairs, nbytes[name])
        ms, q_ms, p_ms = cuda_ms(fn, args), queued_ms(fn, args), cuda_ms(plain, args)
        say(f"time {name} {list(q.shape)} fp32: ms {ms:.4f} (one call between two events) queued_ms {q_ms:.4f} "
            f"(20 calls back to back); {bounds_text(bnd)}; launches {launches.get(name, 0)} a fp32 training step; "
            f"plain_ms {p_ms:.4f} library_ms {lib_ms:.4f} (sdpa backward, {backend}); FMA design before the "
            f"3xTF32 redesign {F32_BWD_MS_BEFORE[name]} ms queued")
        rows[name] = {"ms": ms, "queued_ms": q_ms, "plain_ms": p_ms, "bound_ms": bnd["tf32x3"][0],
                      "bound_by": f"{bnd['tf32x3'][1]} (3xTF32)", "bound_fma_ms": bnd["fma"][0],
                      "library_ms": lib_ms, "library_queued_ms": lib_queued, "library": f"sdpa backward ({backend})",
                      "launches": launches.get(name, 0), "max_abs_err": errs.get((name, torch.float32))}
    return rows


# ---------------------------------------------------------------- training step
def train_pairs(gen, dev, b=TB, n=TN, d=D):
    """A training batch: image 1 holds a permuted, lightly noised copy of half
    of image 0's valid keypoints and fresh keypoints elsewhere; 0-100 padded
    keypoints per image; matching_mask [B, N+1, N+1] marks the copies, and
    every other valid keypoint in the dustbin (padded rows and columns 0)."""
    nv0, nv1 = padded_counts(gen, b, n, n - 100), padded_counts(gen, b, n, n - 100)
    d0, d1 = torch.randn((2, b, n, d), generator=gen)
    k0, k1 = torch.rand((2, b, n, 2), generator=gen) - 0.5
    s0, s1 = torch.rand((2, b, n), generator=gen)
    gt = torch.zeros((b, n + 1, n + 1))
    for i in range(b):
        m = int(min(nv0[i], nv1[i])) // 2
        src = torch.randperm(int(nv0[i]), generator=gen)[:m]
        dst = torch.randperm(int(nv1[i]), generator=gen)[:m]
        d1[i, dst] = d0[i, src] + 0.01 * torch.randn((m, d), generator=gen)
        k1[i, dst], s1[i, dst] = k0[i, src], s0[i, src]
        gt[i, src, dst] = 1
        rest0 = torch.arange(n) < nv0[i]
        rest0[src] = False
        rest1 = torch.arange(n) < nv1[i]
        rest1[dst] = False
        gt[i, :n, n][rest0] = 1
        gt[i, n, :n][rest1] = 1
    data = {"descriptors0": d0, "descriptors1": d1, "norm_keypoints0": k0, "norm_keypoints1": k1,
            "scores0": s0, "scores1": s1, "valid0": torch.arange(n)[None] < nv0[:, None],
            "valid1": torch.arange(n)[None] < nv1[:, None], "matching_mask": gt}
    return {k: x.to(dev) for k, x in data.items()}


@contextlib.contextmanager
def counting_plain_bodies(module, names=PLAIN_BODIES):
    """Count the calls of the kernels' plain versions that `module` (the one
    the autograd Functions and the wrappers look them up in) holds."""
    counts = {name: 0 for name in names}
    originals = {name: getattr(module, name) for name in names}

    def counted(name):
        def fn(*args, **kw):
            counts[name] += 1
            return originals[name](*args, **kw)
        return fn

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def training_models(dev, DGNNS, MatcherConfig, dtype: str = "bfloat16") -> dict:
    """Both routes at the published training config in `dtype` (fp32 is the
    training CLI's default), with the same random weights from a seed."""
    base = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype=dtype)
    models = {"A": DGNNS(base, device=dev, seed=0),
              "B": DGNNS(dataclasses.replace(base, train_fused=True), device=dev, seed=0)}
    say(f"training: eval_config('spp', 15) (the training config's widths: configs/config_train_megadepth.json) "
        f"{dtype}, train_supervision '{base.train_supervision}', B={TB} N={TN} D={D}")
    return models


def zero_grad_leaves(model) -> re.Pattern:
    """Leaves whose exact gradient is 0: a bias that shifts every valid token
    of a channel alike before a masked InstanceNorm (every keypoint-encoder
    block but the last, which no norm follows), and k's bias (a constant per
    softmax row). In bf16 they hold rounding noise: their cosine is printed,
    not held."""
    last = len(model.kenc.blocks) - 1
    return re.compile(rf"(kenc\.blocks\.[0-{last - 1}]\.bias|attn\.[kv]\.bias|merge\.bias|proj\.bias"
                      r"|mlp\.blocks\.0\.bias)$")


def grads_of(model) -> dict:
    return {n: p.grad.detach().float().clone() for n, p in model.named_parameters() if p.grad is not None}


def training_step_check(dev, models, kernels, ka) -> dict:
    """One forward_train + backward a route on the kernel path (launches
    counted from 0, the plain bodies counted) and on the plain path, on the
    same batch and weights, held to the limits of the models' compute dtype.
    Returns the kernel launches of one step."""
    gen = torch.Generator().manual_seed(12)
    batch = train_pairs(gen, dev)
    want = {"A": {"mha_fused": 30, "mha_bwd": 30}, "B": {"mha_fused_lse": 30, "mha_bwd_from_lse": 30}}
    step_launches = {}
    for route, model in models.items():
        step_launches.update(step_check(f"route {route}", model, batch, want[route], kernels, ((ka, PLAIN_BODIES),)))
    return step_launches


def step_check(label, model, batch, want, kernels, plain_bodies, loss_rtol=None, cos_min=None,
               zero=None) -> dict:
    """One forward_train + backward of `model` on the kernel path and on the
    plain path (use_kernels=False), same batch and weights: the kernel path
    must launch `want` and call none of `plain_bodies` ((module, names),
    ...), the plain path launch nothing; loss and gradient cosines held to
    loss_rtol and cos_min (by default the model's compute dtype's limits),
    except the leaves of `zero` (by default `zero_grad_leaves`), whose exact
    gradient is 0. Returns the kernel path's launches."""
    results = {}
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        model.zero_grad(set_to_none=True)
        for fn in kernels.values():
            fn.launches = 0
        with contextlib.ExitStack() as stack:
            counters = [stack.enter_context(counting_plain_bodies(m, names)) for m, names in plain_bodies]
            out = model.forward_train(batch)
            out["loss"].backward()
            torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        calls = collections.Counter()
        for c in counters:
            calls.update(c)
        results[use_kernels] = (out, grads_of(model), launches, dict(calls))
    model.use_kernels = True
    dtype = model.config.compute_dtype
    loss_rtol = TRAIN_LOSS_RTOL[dtype] if loss_rtol is None else loss_rtol
    cos_min = GRAD_COS_MIN[dtype] if cos_min is None else cos_min
    (out, gk, launches, plain_calls), (ref, gp, plain_launches, _) = results[True], results[False]
    expected = {k: want.get(k, 0) for k in kernels}
    say(f"train {label} {dtype}: launches per training step {launches}; plain bodies called on the "
        f"kernel path {plain_calls}; plain path launches {sum(plain_launches.values())}")
    if launches != expected or any(plain_calls.values()) or any(plain_launches.values()):
        fail(f"{label} did not run through its kernels as expected: {launches}, {plain_calls}")
    lk, lp = out["loss"].item(), ref["loss"].item()
    rel = abs(lk - lp) / abs(lp)
    cos = {n: torch.nn.functional.cosine_similarity(gk[n].flatten(), gp[n].flatten(), dim=0).item()
           for n in gp}
    zero = zero_grad_leaves(model) if zero is None else zero
    held = {n: c for n, c in cos.items() if not zero.search(n)}
    worst = min(held, key=held.get)
    worst_zero = min((c for n, c in cos.items() if zero.search(n)), default=float("nan"))
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values()) and bool(torch.isfinite(out["loss"]))
    n_match = (out["matches0"] >= 0).sum(1).tolist()
    say(f"train {label} {dtype}: loss {lk:.6f} plain {lp:.6f} relative difference {rel:.3e} "
        f"(max {loss_rtol:g}); smallest gradient cosine {held[worst]:.8f} at {worst} over "
        f"{len(held)} leaves (min {cos_min}); over the {len(cos) - len(held)} leaves whose exact "
        f"gradient is 0 {worst_zero:.3f} (rounding noise, not held); matches0 {n_match}; "
        f"acc_corr {out['acc_corr'].item():.2f} of {out['total_acc_corr'].item():.2f}; finite {finite}")
    if not finite or gk.keys() != gp.keys() or out["matches0"].shape != batch["valid0"].shape:
        fail(f"{label}: non-finite or misshapen training output")
    if rel > loss_rtol or held[worst] < cos_min:
        fail(f"{label}: the kernel path's loss or gradients disagree with the plain path")
    return {k: v for k, v in launches.items() if v}


def training_runs(dev, models, launches, TrainHyperParams, make_train_step, init_opt_state,
                  init_stats, steps: int = TRAIN_STEPS, fixed_steps: int = FIXED_STEPS):
    """Phases 11 and 12 for each route: `steps` timed steps on fresh batches
    (train pairs/s, peak memory, one step profiled: the route's attention
    backward must take two device launches a wrapper call, whose count per
    step is `launches`), then `fixed_steps` on one batch (the loss must
    fall). Any skipped step fails."""
    gen = torch.Generator().manual_seed(13)
    fresh = [train_pairs(gen, dev) for _ in range(steps + 2)]
    fixed = train_pairs(gen, dev)
    hp = TrainHyperParams()  # the published lr 1e-4 and decay schedule
    for route, model in models.items():
        dtype = model.config.compute_dtype
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        opt, stats = init_opt_state(model), init_stats(dev)
        step = make_train_step(model, hp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, bad = [], []
        for it, batch in enumerate(fresh):
            t0 = time.perf_counter()
            metrics, stats = step(opt, it, batch, stats)
            torch.cuda.synchronize()
            if it >= 2:  # two warm-up steps
                times.append(time.perf_counter() - t0)
            bad.append(metrics["bad_loss"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        skipped = int(torch.stack(bad).sum().item())
        med = statistics.median(times)
        say(f"train route {route} {dtype}: {len(times)} make_train_step steps on fresh batches, median "
            f"{1e3 * med:.1f} ms a step = train_pairs_per_s {TB / med:.2f} (steps ms "
            f"{[round(1e3 * t, 1) for t in times]}); peak device memory {peak:.2f} GiB; skipped steps {skipped}")
        if skipped:
            fail(f"route {route}: the NaN guard skipped {skipped} steps")
        per_step = profile_calls(f"training step route {route} {dtype} B={TB} N={TN}",
                                 lambda d: step(opt, steps + 2, d, stats), [fresh[0]])
        bwd = "mha_bwd" if route == "A" else "mha_bwd_from_lse"
        if per_step is not None:
            device = per_step[f"{bwd} (csrc/attention_bwd.cu)"][1]
            say(f"train route {route} {dtype}: {bwd} takes {device / launches[bwd]:g} device launches a call "
                f"({device:.0f} in the profiled step over {launches[bwd]} wrapper calls; a dq launch "
                f"and a dk/dv launch)")
            if device != 2 * launches[bwd]:
                fail(f"route {route} {dtype}: {bwd} did not take two device launches a call")
            busy = sum(ms for ms, _ in per_step.values())
            say(f"train route {route} {dtype}: the backward group {per_step[f'{bwd} (csrc/attention_bwd.cu)'][0]:.3f} "
                f"ms, cuBLAS {per_step['matmul (cuBLAS)'][0]:.3f} ms = {per_step['matmul (cuBLAS)'][0] / busy:.3f} of "
                f"the step's {busy:.3f} ms of device time")
        if not fixed_steps:
            continue

        model.load_state_dict(state)
        opt, stats = init_opt_state(model), init_stats(dev)
        losses, bad = [], []
        for it in range(fixed_steps):
            metrics, stats = step(opt, it, fixed, stats)
            losses.append(metrics["loss"])
            bad.append(metrics["bad_loss"])
        losses = [x.item() for x in losses]
        skipped = int(torch.stack(bad).sum().item())
        say(f"train route {route} {dtype}: {fixed_steps} steps on one batch, loss {[round(x, 5) for x in losses]}, "
            f"skipped steps {skipped}")
        if skipped or not losses[-1] < losses[0]:
            fail(f"route {route}: the loss did not fall over {fixed_steps} steps on one batch, or a step was skipped")


# ---------------------------------------------------------------- log-domain head
def log_sinkhorn_bound(dist, valid0, valid1, iterations: int) -> tuple[float, str, float]:
    """Least time: one exponential per cell of each pair's valid (n0+1) x
    (n1+1) block in each of the 2 * iterations sweeps at the special-function
    rate, versus reading the valid cells of dist once and writing u, v, max0,
    idx0 and idx1."""
    b, n, m = dist.shape
    n0, n1 = valid0.sum(1).double(), valid1.sum(1).double()
    exps = 2 * iterations * ((n0 + 1) * (n1 + 1)).sum().item()
    nbytes = 4 * (n0 * n1).sum().item() + 4 * b * (n + 1 + m + 1 + 2 * n + m)
    t_ops, t_bytes = exps / SFU_EXP_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), 1e3 * t_bytes


def check_log_sinkhorn(dev, log_sinkhorn_fused_stats, log_sinkhorn_stats_reference, plan_dtype):
    """Kernel 7 against its plain version: u and v at valid entries and the
    dustbin and max0 by LOG_RTOL/LOG_ATOL, u and v at invalid entries by
    LOG_INVALID_ATOL, the argmax indices by their share of flips, and a second
    run for the same bits. Prints every check before failing on any. Returns
    the largest error at the main shape and 20 iterations."""
    gen = torch.Generator().manual_seed(14)
    worst, failures = 0.0, []
    for shape, iters in ((dict(), LOG_ITERS[0]), (dict(), LOG_ITERS[1]), (dict(b=2, n=256, m=200, pad=100), LOG_ITERS[0]),
                         (dict(m=ROUTE_N1), LOG_ITERS[1])):   # SuperGlue's plan at N0 != N1 (phase 18)
        dist, bin_, v0, v1 = sinkhorn_inputs(gen, dev, **shape)
        out = log_sinkhorn_fused_stats(dist, bin_, iters, v0, v1)
        again = log_sinkhorn_fused_stats(dist, bin_, iters, v0, v1)
        torch.cuda.synchronize()
        ref = log_sinkhorn_stats_reference(dist, bin_, iters, v0, v1)
        b, n, m = dist.shape
        where = f"{[b, n, m]} Z {str(plan_dtype(n, m))[6:]} {iters} iterations"
        same = all(torch.equal(out[k], again[k]) for k in out)
        one = torch.ones((b, 1), dtype=torch.bool, device=dev)
        for key, ok in (("u", torch.cat([v0, one], 1)), ("v", torch.cat([v1, one], 1)),
                        ("max0", torch.ones_like(v0))):
            err = (out[key] - ref[key]).abs()
            bad = (err[ok] > LOG_ATOL + LOG_RTOL * ref[key][ok].abs()).sum().item()
            inv = err[~ok].max().item() if bool((~ok).any()) else 0.0
            finite = bool(torch.isfinite(out[key]).all())
            say(f"check log_sinkhorn {where} {key}: max_abs_err {err[ok].max().item():.3e} over valid "
                f"entries (tol rtol={LOG_RTOL:g} atol={LOG_ATOL:g}), out of tolerance {bad}; invalid "
                f"entries max_abs_err {inv:.3e} (max {LOG_INVALID_ATOL:g}); finite {finite}")
            if bad or inv > LOG_INVALID_ATOL or not finite:
                failures.append(f"{key} at {where}")
            if not shape and iters == LOG_ITERS[0]:
                worst = max(worst, err[ok].max().item())
        for key in ("idx0", "idx1"):
            flips = (out[key] != ref[key]).float().mean().item()
            say(f"check log_sinkhorn {where} {key}: share differing {flips:.2e} (max {IDX_FLIP_MAX:g})")
            if flips > IDX_FLIP_MAX:
                failures.append(f"{key} at {where}")
        say(f"check log_sinkhorn {where}: second run bitwise equal {same}")
        if not same:
            failures.append(f"second run at {where}")
        if not shape and iters == LOG_ITERS[0]:
            graph_replay(f"log_sinkhorn_fused_stats {where}", log_sinkhorn_fused_stats,
                         (dist, bin_, iters, v0, v1))
    if failures:
        fail(f"log-Sinkhorn kernel disagrees with its plain version or itself: {failures}")
    return worst


def time_log_sinkhorn(dev, log_sinkhorn_fused_stats, log_sinkhorn_stats_reference, plan_dtype, err, launches):
    """Kernel 7 and its plain version at dist [B, N, N], 0-300 padded, at
    both iteration counts; the row of the kernels' JSON line takes 20."""
    gen = torch.Generator().manual_seed(15)
    sk = [sinkhorn_inputs(gen, dev) for _ in range(3)]
    b, n, m = sk[0][0].shape
    row = None
    for iters in LOG_ITERS:
        run_k = lambda d, bn, a, c: log_sinkhorn_fused_stats(d, bn, iters, a, c)
        k_ms, k_queued = cuda_ms(run_k, sk), queued_ms(run_k, sk)
        p_ms = cuda_ms(lambda d, bn, a, c: log_sinkhorn_stats_reference(d, bn, iters, a, c), sk)
        b_ms, b_by, b_bytes = log_sinkhorn_bound(sk[0][0], sk[0][2], sk[0][3], iters)
        say(f"time log_sinkhorn_fused_stats {[b, n, m]} {iters} iterations: ms {k_ms:.4f} (one call between "
            f"two events) queued_ms {k_queued:.4f} (20 calls back to back: device time) bound_ms "
            f"{b_ms:.4f} ({b_by}: the exponentials at the special-function rate; reading dist once "
            f"{1e3 * b_bytes:.2f} us) launches {launches} plain_ms {p_ms:.4f} library_ms none")
        if iters == LOG_ITERS[0]:
            row = {"name": "log_sinkhorn_fused_stats", "route": "cuda", "source": "impx_torch/csrc/log_sinkhorn.cu",
                   "replaces": "impx/ops/pallas/log_sinkhorn.py:208", "launches": launches,
                   "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
    from impx_torch.ops.kernels import log_sinkhorn as kl

    say(schedule_line(f"schedule log_sinkhorn_fused_stats {[b, n, m]} Z {str(plan_dtype(n, m))[6:]}",
                      kl.schedule(b, n, m, dev)))
    return row


def log_ot_path(dev, DGNNS, MatcherConfig, load_reference_state_dict, kernels):
    """Phase 14: DGNNS at the eval config under the log-domain head."""
    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="bfloat16", log_ot=True)
    model = carried_model(DGNNS, cfg, dev, reference_layout, load_reference_state_dict)
    say(f"log_ot path: eval_config('spp', 15) log_ot bf16, {cfg.sinkhorn_iterations} iterations, "
        f"B={B} N={N} D={D}")
    call = lambda d: model.produce_matches(d, only_last=True, with_scores=False)
    gen = torch.Generator().manual_seed(16)
    launches = drive_path("log_ot path", model, permuted_pairs(gen, dev), call,
                          {"mha_fused": 2 * cfg.n_layers, "log_sinkhorn_fused_stats": 1}, kernels)
    label = f"DGNNS log_ot produce_matches B={B} N={N} 15 layers bf16"
    time_path(label, model, call, [(permuted_pairs(gen, dev),) for _ in range(4)])
    profile_calls(label, call, [permuted_pairs(gen, dev) for _ in range(4)])
    return launches


def randomize_batch_norm(model, gen):
    """Random scale, bias and running statistics in every batch norm (at
    their initial 1, 0, 0, 1 eval-mode batch norm is the identity up to eps)."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "bn_var"):
                c = m.bn_var.shape[0]
                u = lambda lo, hi: (lo + (hi - lo) * torch.rand(c, generator=gen)).to(m.bn_var.device)
                m.bn_scale.copy_(u(0.5, 1.5))
                m.bn_bias.copy_(u(-0.3, 0.3))
                m.bn_mean.copy_((0.3 * torch.randn(c, generator=gen)).to(m.bn_var.device))
                m.bn_var.copy_(u(0.3, 2.0))


def superglue_pairs(gen, dev):
    data = permuted_pairs(gen, dev)
    for k in ("descriptors0", "descriptors1"):
        data[k] = SG_DESC_SCALE * data[k]
    return data


def superglue_path(dev, SuperGlue, MatcherConfig, load_superglue_state_dict, kernels):
    """Phase 15: SuperGlue at its published configuration."""
    cfg = MatcherConfig(descriptor_dim=D, n_layers=SG_LAYERS, sinkhorn_iterations=SG_ITERS,
                        match_threshold=0.2, norm_fn="bn", compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(17)
    model = carried_model(SuperGlue, cfg, dev, lambda m: reference_layout(m, single_final_proj=True),
                          load_superglue_state_dict, lambda m: randomize_batch_norm(m, gen))
    say(f"superglue: D={cfg.descriptor_dim} encoder {tuple(cfg.keypoint_encoder)} {cfg.num_heads} heads "
        f"{cfg.n_layers} x (self, cross) {cfg.sinkhorn_iterations} iterations threshold "
        f"{cfg.match_threshold} norm {cfg.norm_fn} (eval mode, random running statistics) bf16 "
        f"attention, fp32 stream; descriptors x{SG_DESC_SCALE}; B={B} N={N}")
    call = lambda d: model.produce_matches(d, only_last=True)
    launches = drive_path("superglue", model, superglue_pairs(gen, dev), call,
                          {"mha_fused": 2 * cfg.n_layers, "log_sinkhorn_fused_stats": 1}, kernels)
    label = f"SuperGlue produce_matches B={B} N={N} {cfg.n_layers} layers {cfg.sinkhorn_iterations} iterations"
    time_path(label, model, call, [(superglue_pairs(gen, dev),) for _ in range(4)])
    profile_calls(label, call, [superglue_pairs(gen, dev) for _ in range(4)])
    return launches

# ---------------------------------------------------------------- the remaining inference routes
ROUTE_PROFILE_CALLS = 2
F_PAIRS = 16                      # FMBenchEval pairs, true correspondences plus RECOVERY_OUTLIER_SHARE outliers
F_PRECISION_SLACK = 0.05          # the device backend's mean precision after RANSAC, at least cv2's less this
F_SGD_MAX = 1e-2                  # the device backend's mean symmetric geometric distance to the true F


def cut_image1(data, m=ROUTE_N1):
    """The pairs with image 1 cut to its first m keypoints (N0 != N1)."""
    return {k: (x[:, :m] if k.endswith("1") else x) for k, x in data.items()}


def recording_pools(model):
    """Wrap the model's pooling rule: (keep counts before, after) of each pool."""
    pools = []

    def recording(*args, _orig=model._pool_from_masses):
        new0, new1 = _orig(*args)
        pools.append(([args[6].sum(1).tolist(), args[7].sum(1).tolist()],
                      [new0.sum(1).tolist(), new1.sum(1).tolist()]))
        return new0, new1

    model._pool_from_masses = recording
    return pools


def fundamental_path(dev):
    """(g): FMBenchEval's device backend against its cv2 one on F_PAIRS
    synthetic pairs (true correspondences plus RECOVERY_OUTLIER_SHARE of
    random pairings of outlier keypoints, pixels): each backend's mean
    precision after RANSAC and symmetric geometric distance, and the device
    backend's ms a pair (host clock, ending in the copy of F and the inlier
    mask to the host)."""
    from impx_torch.data.synthetic import synthesize_pair
    from impx_torch.eval.evaluator import FMBenchEval

    rs = np.random.RandomState(23)
    infos = []
    while len(infos) < F_PAIRS:
        p = synthesize_pair(rs, n_inliers=1000, n_outliers0=1000, n_outliers1=1000, desc_dim=8,
                            image_size=(480, 640))
        gt = p["gt_matches"]
        if len(gt) < RECOVERY_MIN_TRUE:
            continue                      # views that overlap little: too few true correspondences
        n_out = int(round(len(gt) * RECOVERY_OUTLIER_SHARE / (1 - RECOVERY_OUTLIER_SHARE)))
        out0 = np.setdiff1d(np.arange(len(p["kpt1"])), gt[:, 0])
        out1 = np.setdiff1d(np.arange(len(p["kpt2"])), gt[:, 1])
        i0 = np.concatenate([gt[:, 0], rs.choice(out0, n_out, replace=False)])
        i1 = np.concatenate([gt[:, 1], rs.choice(out1, n_out, replace=False)])
        infos.append({"corr1": p["kpt1"][i0, :2].copy(), "corr2": p["kpt2"][i1, :2].copy(), "f": p["f"],
                      "img_size1": p["img_size1"], "img_size2": p["img_size2"]})
    res = {}
    for backend in ("device", "cv2"):
        ev = FMBenchEval({"f_backend": backend, "inlier_th": 1.0, "seed": 0}, device=dev)
        ev.run(infos[0])                                  # warm-up: the solver libraries' first calls
        ev = FMBenchEval({"f_backend": backend, "inlier_th": 1.0, "seed": 0}, device=dev)
        ms = []
        for info in infos:
            t0 = time.perf_counter()
            ev.res_inqueue(ev.run(info))
            ms.append(1e3 * (time.perf_counter() - t0))
        res[backend] = (float(np.mean(ev.pre)), float(np.mean(ev.pre_post)), float(np.mean(ev.sgd)),
                        float(np.mean(ev.num_corr_post)), statistics.median(ms))
        say(f"routes FMBenchEval f_backend {backend!r} on {F_PAIRS} pairs (about {int(np.mean(ev.num_corr))} "
            f"correspondences, {RECOVERY_OUTLIER_SHARE:.0%} outliers, 1 px): precision before {res[backend][0]:.4f}, "
            f"after RANSAC {res[backend][1]:.4f}, mean SGD {res[backend][2]:.3e}, inliers kept "
            f"{res[backend][3]:.1f}; {res[backend][4]:.3f} ms a pair (median, host clock, ending in a copy to the "
            f"host)")
    dev_pre, cv_pre = res["device"][1], res["cv2"][1]
    if not (dev_pre >= cv_pre - F_PRECISION_SLACK and res["device"][2] <= F_SGD_MAX):
        fail(f"FMBenchEval's device backend falls short: precision after RANSAC {dev_pre:.4f} against cv2's "
             f"{cv_pre:.4f} (slack {F_PRECISION_SLACK}), SGD {res['device'][2]:.3e} (max {F_SGD_MAX})")


def routes_path(dev, kernels, DGNNS, AdaGMN, SuperGlue, MatcherConfig, load_reference_state_dict,
                load_superglue_state_dict) -> dict:
    """Phase 18: the inference routes of the thirteenth slice at full width
    (eval_config('spp', 15), D = 256, 4 pairs; SuperGlue at its published
    configuration), random weights carried through the reference layout,
    each on the kernel and the plain path: (a) IMP with the dual-softmax head,
    (b) EIMP mask-only with it, (c) DGNNS with batch norm at N0 = N1 and
    N0 != N1, (d) EIMP's masked loop at N0 != N1, (e) the masked loop under
    log_ot, (f) SuperGlue at N0 != N1, (g) FMBenchEval's device backend
    against cv2. Returns the launches of each kernel over the kernel-path
    runs."""
    from impx_torch.models.fast import _eimp_do_pool

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(24)
    eval15 = MatcherConfig.eval_config("spp", 15)
    pools = sum(_eimp_do_pool(eval15))
    total = dict.fromkeys(kernels, 0)
    only_last = lambda m: (lambda d: m.produce_matches(d, only_last=True, with_scores=False))  # noqa: E731

    def run(label, model, make, want, keeps=False, call=None):
        call, label = call or only_last(model), f"routes {label}"
        launches = drive_path(label, model, make(), call, want, kernels, keeps)
        for k, v in launches.items():
            total[k] += v
        pairs = [make() for _ in range(4)]
        k_ms = cuda_ms(call, [(p,) for p in pairs])       # the kernel path only: the script's time is bounded
        say(f"time {label}: kernel path {k_ms:.3f} ms = pairs_per_s {1e3 * B / k_ms:.2f}")
        profile_calls(label, call, pairs[:ROUTE_PROFILE_CALLS])

    def with_bin_score(model):
        model.bin_score.data.fill_(EIMP_BIN_SCORE)

    # (a) IMP, dual-softmax head, bf16, stacked: kernel 2 off the path
    cfg = dataclasses.replace(eval15, compute_dtype="bfloat16", with_sinkhorn=False)
    model = carried_model(DGNNS, cfg, dev, reference_layout, load_reference_state_dict)
    run("(a) IMP dual softmax bf16 N=2048", model, lambda: permuted_pairs(gen, dev), {"mha_fused": 2 * cfg.n_layers})
    # (b) EIMP mask-only, dual-softmax head, bf16
    model = carried_model(AdaGMN, cfg, dev, reference_layout, load_reference_state_dict, with_bin_score)
    run("(b) EIMP mask-only dual softmax bf16 N=2048", model, lambda: overlap_pairs(gen, dev),
        {"mha_fused": 2 * (cfg.n_layers - pools), "mha_fused_lse": 2 * pools, "attention_key_mass": 2 * pools},
        keeps=True, call=lambda d: model.produce_matches(d, only_last=True, with_scores=False))
    # (c) DGNNS with batch norm (random running statistics), fp32, GM's
    # unrolled forward: stacked at N0 = N1, one launch an image at N0 != N1
    cfg = dataclasses.replace(eval15, norm_fn="bn")
    model = carried_model(DGNNS, cfg, dev, reference_layout, load_reference_state_dict,
                          lambda m: randomize_batch_norm(m, gen))
    say(f"routes (c): DGNNS norm_fn 'bn' in eval mode {not model.training}, fp32, plain Sinkhorn head")
    run("(c) DGNNS bn fp32 N=2048", model, lambda: superglue_pairs(gen, dev), {"mha_fused": 2 * cfg.n_layers})
    run(f"(c) DGNNS bn fp32 N0=2048 N1={ROUTE_N1}", model, lambda: cut_image1(superglue_pairs(gen, dev)),
        {"mha_fused": 4 * cfg.n_layers})
    del model
    # (d) EIMP's masked loop, 'in', fp32, N0 != N1: per-image layers, a mass
    # launch a direction on each pooling iteration, the plain Sinkhorn head
    cfg = eval15
    model = carried_model(AdaGMN, cfg, dev, reference_layout, load_reference_state_dict, with_bin_score)
    pooled = recording_pools(model)
    run(f"(d) EIMP masked loop fp32 N0=2048 N1={ROUTE_N1}", model, lambda: cut_image1(overlap_pairs(gen, dev)),
        {"mha_fused": 4 * cfg.n_layers, "attention_key_mass": 4 * pools}, keeps=True,
        call=lambda d: model.produce_matches(d, only_last=True, with_scores=False))
    say(f"routes (d) keep counts (before, after) of the kernel path's pools: {pooled[:pools]}")
    del model
    # (e) the masked loop under log_ot, bf16: kernel 7 every iteration, pooling on the plan
    cfg = dataclasses.replace(eval15, compute_dtype="bfloat16", log_ot=True)
    model = carried_model(AdaGMN, cfg, dev, reference_layout, load_reference_state_dict, with_bin_score)
    pooled = recording_pools(model)
    run("(e) EIMP masked loop log_ot bf16 N=2048", model, lambda: overlap_pairs(gen, dev),
        {"mha_fused": 2 * (cfg.n_layers - pools), "mha_fused_lse": 2 * pools, "attention_key_mass": 2 * pools,
         "log_sinkhorn_fused_stats": cfg.n_layers}, keeps=True,
        call=lambda d: model.produce_matches(d, only_last=True, with_scores=False))
    first = pooled[:pools]
    say(f"routes (e) keep counts (before, after) of the kernel path's pools: {first}")
    fell = any(a < b for before, after in first for b_side, a_side in zip(before, after)
               for b, a in zip(b_side, a_side))
    say(f"routes (e): keep counts fall under log_ot (pooling on the plan, exp of the log plan) {fell}")
    if not fell:
        fail("routes (e): no pool under log_ot dropped a keypoint")
    del model
    # (f) SuperGlue at its published configuration, N0 != N1: kernel 7 on an N != M plan
    cfg = MatcherConfig(descriptor_dim=D, n_layers=SG_LAYERS, sinkhorn_iterations=SG_ITERS, match_threshold=0.2,
                        norm_fn="bn", compute_dtype="bfloat16")
    model = carried_model(SuperGlue, cfg, dev, lambda m: reference_layout(m, single_final_proj=True),
                          load_superglue_state_dict, lambda m: randomize_batch_norm(m, gen))
    run(f"(f) SuperGlue N0=2048 N1={ROUTE_N1}", model, lambda: cut_image1(superglue_pairs(gen, dev)),
        {"mha_fused": 4 * cfg.n_layers, "log_sinkhorn_fused_stats": 1},
        call=lambda d: model.produce_matches(d, only_last=True))
    del model
    fundamental_path(dev)
    say(f"routes phase {time.perf_counter() - t_phase:.1f} s; kernel launches over its kernel-path runs {total}")
    return total


# ---------------------------------------------------------------- phase 19: from images to matches
SP_CHECK_SHAPE, SP_CHECK_KPT = (1, 120, 160), 256     # SuperPoint on the card vs the CPU, fp32
SP_BF16_SHAPE, SP_BF16_KPT = (1, 480, 640), 1024      # bf16 vs fp32 on the card
SP_RTOL, SP_ATOL = 1e-4, 1e-5     # dense scores and descriptors (the reference's parity bound)
SP_OVERLAP_MIN, SP_BF16_COS_MIN = 0.85, 0.995   # impx's bf16 extraction test (tests/test_superpoint.py)
# bench_suite.py:659's configurations: height, width, images a call, keypoints, dtype
SP_CONFIGS = ((480, 640, 4, 1024, torch.bfloat16), (480, 640, 4, 1024, torch.float32),
              (1200, 1600, 2, 2048, torch.bfloat16))
SCANNET_HW, SCANNET_KPT = (480, 640), 1024   # bench_suite.py:598: scannet_sp.yaml's 1000, bucketed
PAIR_SHIFT = 8                    # image 1 of a pair: image 0's texture moved this many pixels
DEMO_FX = 500.0
REPROJ_N = 4096                   # keypoints a side: dump_megadepth.py's SuperPoint budget
POOL_KEYS = ("max_pool",)
SORT_KEYS = ("sort", "topk", "TopK", "radix", "bitonic")
CONV_KEYS = ("fprop", "conv", "implicit", "cudnn", "nchw", "nhwc", "winograd")
# SuperPoint alone: its 1x1 convs may run as GEMMs, counted with the convolutions
SP_GROUPS = (("pools and NMS (max_pool2d)", POOL_KEYS), ("sort/top-k", SORT_KEYS),
             ("convolutions (cuDNN)", CONV_KEYS + ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
             ("descriptor sampling (gathers)", ("gather",)))
E2E_GROUPS = SP_GROUPS[:2] + (("convolutions (cuDNN)", CONV_KEYS),) + KERNEL_GROUPS + SP_GROUPS[3:]


def textures(gen, b: int, h: int, w: int) -> torch.Tensor:
    """b blurred noise images [b, 1, h, w] in [0, 1] (a 5x5 binomial blur:
    blobs a few pixels across, which the detector and SIFT respond to)."""
    x = torch.rand((b, 1, h + 4, w + 4), generator=gen)
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0]) / 16
    x = torch.nn.functional.conv2d(x, (k[:, None] * k[None, :])[None, None])
    return (x - x.amin()) / (x.amax() - x.amin())


def image_pairs(gen, dev, b: int, h: int, w: int):
    """b pairs: image 1 is image 0's texture moved PAIR_SHIFT pixels to the left."""
    t = textures(gen, b, h, w + PAIR_SHIFT)
    return t[..., :w].contiguous().to(dev), t[..., PAIR_SHIFT:].contiguous().to(dev)


def check_superpoint(dev, SuperPoint, compare_extractions, ieee_fp32_convs, conv) -> list[str]:
    """Phase 19 (a): SuperPoint on the card at fp32 (cuDNN's TF32 off) against
    the same module on the CPU, and bf16 against fp32 on the card, by impx's
    margin rule; the bf16 conv's one-pass bias epilogue against its two-pass
    form. Returns the failures; prints every check first."""
    failures = []
    with ieee_fp32_convs():
        inside = torch.backends.cudnn.allow_tf32
    say(f"frontend: cudnn allow_tf32 {torch.backends.cudnn.allow_tf32}, inside SuperPoint's fp32 convs {inside}")
    if inside:
        failures.append("SuperPoint's fp32 convs run with cuDNN's TF32 on")
    gen = torch.Generator().manual_seed(40)
    cpu, card = SuperPoint(device="cpu", seed=3), SuperPoint(device=dev, seed=3)
    img = textures(gen, *SP_CHECK_SHAPE)
    (sc, dc), (sg, dg) = cpu.backbone(img), card.backbone(img.to(dev))
    for name, got, want in (("dense scores", sg.cpu(), sc), ("dense descriptors", dg.cpu(), dc)):
        err = (got - want).abs()
        excess = float((err - SP_RTOL * want.abs()).max())
        say(f"frontend superpoint fp32 card vs CPU {list(img.shape)} {name}: max_abs_err {float(err.max()):.3e}, "
            f"max excess over rtol {SP_RTOL} {excess:.3e} (atol {SP_ATOL})")
        if excess > SP_ATOL:
            failures.append(f"SuperPoint {name} on the card differ from the CPU's")
    margin = float((sg.cpu() - sc).abs().max())
    cmp = compare_extractions(card(img.to(dev), max_keypoints=SP_CHECK_KPT), cpu(img, max_keypoints=SP_CHECK_KPT),
                              margin)
    say(f"frontend superpoint fp32 card vs CPU keypoints: {cmp['n']} valid, overlap {cmp['overlap']:.4f} "
        f"(min {SP_OVERLAP_MIN}), unexplained {cmp['unexplained'][:8]}, min descriptor cosine "
        f"{cmp['min_cosine']:.6f}")
    if cmp["overlap"] < SP_OVERLAP_MIN or cmp["unexplained"]:
        failures.append("SuperPoint's keypoints on the card break the margin rule against the CPU's")
    x = torch.rand((2, 64, 120, 160), generator=gen).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    params = card.params()
    w, bias = params["conv1b.weight"], params["conv1b.bias"]
    want = (torch.nn.functional.conv2d(x, w.to(torch.bfloat16), padding=1).float() + bias[:, None, None]).to(
        torch.bfloat16).detach()
    with torch.no_grad():
        same = torch.equal(conv(params, "conv1b", x), want)
    say(f"frontend superpoint bf16 conv epilogue (fp32 bias add, one rounding, in place) equals "
        f"(conv.float() + bias).to(bf16): {same}")
    if not same:
        failures.append("SuperPoint's bf16 conv epilogue differs from its two-pass form")
    big = textures(gen, *SP_BF16_SHAPE).to(dev)
    s32, _ = card.backbone(big)
    s16, _ = card.backbone(big, compute_dtype=torch.bfloat16)
    span, margin16 = float(s32.max() - s32.min()), float((s16 - s32).abs().max())
    cmp = compare_extractions(card(big, max_keypoints=SP_BF16_KPT),
                              card(big, compute_dtype=torch.bfloat16, max_keypoints=SP_BF16_KPT), margin16)
    say(f"frontend superpoint bf16 vs fp32 on the card {list(big.shape)}: dense score drift {margin16:.3e} of span "
        f"{span:.3e}; keypoints {cmp['n']}, overlap {cmp['overlap']:.4f} (min {SP_OVERLAP_MIN}), unexplained "
        f"{cmp['unexplained'][:8]}, min descriptor cosine {cmp['min_cosine']:.6f} (min {SP_BF16_COS_MIN})")
    if (cmp["overlap"] < SP_OVERLAP_MIN or cmp["unexplained"] or cmp["min_cosine"] < SP_BF16_COS_MIN
            or margin16 >= 0.15 * span):
        failures.append("SuperPoint bf16 breaks impx's bf16 rule against fp32 on the card")
    return failures


def time_superpoint(dev, SuperPoint, sp_fns):
    """Phase 19 (b): SuperPoint ms an image at bench_suite.py's configurations
    (CUDA events, fresh images), its stages at 480 x 640 bf16 one by one, the
    top-k alone on 1200 x 1600's 1.92 M pixels, and a profile by group."""
    backbone, simple_nms, top_k, sample_descriptors = sp_fns
    gen = torch.Generator().manual_seed(41)
    model = SuperPoint(device=dev, seed=1)
    for h, w, b, k, dtype in SP_CONFIGS:
        images = [(textures(gen, b, h, w).to(dev),) for _ in range(3)]
        call = lambda x, dtype=dtype, k=k: model(x, compute_dtype=dtype, max_keypoints=k)  # noqa: E731
        ms = cuda_ms(call, images)
        say(f"time superpoint {h}x{w} B={b} K={k} {str(dtype)[6:]}: {ms:.3f} ms a call = {ms / b:.3f} ms an image")
        if (h, w, dtype) == (480, 640, torch.bfloat16):
            params, x = model.params(), images[0][0]
            scores, desc = backbone(params, x, dtype)
            nms = simple_nms(scores, 4)
            flat = nms.reshape(b, -1)
            _, idx = top_k(flat, k)
            kp = torch.stack([(idx % w).float(), (idx // w).float()], -1)
            stages = {"backbone (convs, softmax, norm)": (lambda x: backbone(params, x, dtype), (x,)),
                      "simple_nms": (lambda s: simple_nms(s, 4), (scores,)),
                      "top_k": (lambda f: top_k(f, k), (flat,)),
                      "sample_descriptors": (sample_descriptors, (kp, desc))}
            for name, (fn, args) in stages.items():
                say(f"time superpoint {h}x{w} bf16 stage {name}: {cuda_ms(fn, [args]):.3f} ms a call of {b}")
            profile_calls(f"superpoint {h}x{w} B={b} bf16", call, [x for (x,) in images[:2]], SP_GROUPS)
        if (h, w) == (1200, 1600):
            flat = torch.rand((b, h * w), generator=gen).to(dev)
            say(f"time superpoint top_k [{b}, {h * w}] K={k} (composite int64 key, torch.topk): "
                f"{cuda_ms(lambda f: top_k(f, k), [(flat,)]):.3f} ms")
    return model


def frontend_features(model, pair, hw=SCANNET_HW, k=SCANNET_KPT):
    """The ScanNet protocol's features of a batch of pairs: bf16 SuperPoint at
    k keypoints on each image, keypoints normalised as the matcher takes them."""
    from impx_torch.geometry.keypoints import normalize_keypoints

    feed = {}
    for i, img in enumerate(pair):
        f = model(img, compute_dtype=torch.bfloat16, max_keypoints=k)
        feed.update({f"descriptors{i}": f["descriptors"], f"norm_keypoints{i}": normalize_keypoints(f["keypoints"], *hw),
                     f"scores{i}": f["scores"], f"valid{i}": f["valid"]})
    return feed


def scannet_e2e(dev, sp_model, DGNNS, MatcherConfig, load_reference_state_dict, kernels) -> dict:
    """Phase 19 (c), bench_suite.py:598 (bench_scannet_e2e) on the card: 4
    pairs of 480 x 640 images -> bf16 SuperPoint at 1024 keypoints -> IMP
    bf16 produce_matches (eval_config('spp', 15)). Launches a call, no plain
    body on the kernel path, indices0 agreement with the plain matcher path
    on the same features, pairs/s and SuperPoint's share, a profile."""
    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="bfloat16")
    matcher = carried_model(DGNNS, cfg, dev, reference_layout, load_reference_state_dict)
    gen = torch.Generator().manual_seed(42)
    pairs = [image_pairs(gen, dev, B, *SCANNET_HW) for _ in range(3)]
    match = lambda feed: matcher.produce_matches(feed, p=0.2, only_last=True, with_scores=False)  # noqa: E731
    e2e = lambda pair: match(frontend_features(sp_model, pair))  # noqa: E731
    for fn in kernels.values():
        fn.launches = 0
    with counting_inference_plain_bodies() as plain:
        feed = frontend_features(sp_model, pairs[0])
        out = match(feed)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    n_plain = sum(n for counts in plain for n in counts.values())
    want = {**dict.fromkeys(kernels, 0), "mha_fused": 2 * cfg.n_layers, "sinkhorn_fused_stats": 1}
    matcher.use_kernels = False
    ref = match(feed)
    matcher.use_kernels = True
    idx, ridx, valid = out["indices0"][-1], ref["indices0"][-1], feed["valid0"]
    agree = (idx == ridx)[valid].float().mean().item()
    say(f"frontend scannet e2e launches per call {launches}; plain bodies on the kernel path {n_plain}; valid "
        f"keypoints {valid.sum(1).tolist()} / {feed['valid1'].sum(1).tolist()}; matches "
        f"{(idx >= 0).sum(1).tolist()} (plain {(ridx >= 0).sum(1).tolist()}); indices0 agreement {agree:.4f} "
        f"(min {E2E_AGREE_MIN}) over valid rows")
    failures = []
    if launches != want or n_plain:
        failures.append(f"the ScanNet protocol did not run through kernels 1 and 2 alone: {launches}, {n_plain} plain")
    if agree < E2E_AGREE_MIN or idx.shape != valid.shape or not bool(torch.isfinite(out["mscores0"][-1]).all()):
        failures.append("the ScanNet protocol's matches disagree with the plain path or are not finite")
    e2e_ms = cuda_ms(e2e, [(p,) for p in pairs])
    sp_ms = cuda_ms(lambda p: frontend_features(sp_model, p), [(p,) for p in pairs])
    say(f"time frontend scannet e2e B={B} {SCANNET_HW[0]}x{SCANNET_HW[1]} K={SCANNET_KPT}: {e2e_ms:.3f} ms = "
        f"pairs_per_s {1e3 * B / e2e_ms:.2f}; SuperPoint on both images {sp_ms:.3f} ms, share {sp_ms / e2e_ms:.3f}")
    profile_calls(f"scannet e2e B={B}", e2e, pairs[:2], E2E_GROUPS)
    return {"launches": launches, "failures": failures}


def demo_runs(dev, SuperPoint, kernels, eimp_pools: int) -> dict:
    """Phase 19 (d): impx_torch.demo.main on two synthetic PNGs written to a
    temporary directory, --fx set: SuperPoint (random weights saved in the
    reference layout), SIFT (IMP at D = 128: kernel 1 at dh 32), and EIMP.
    Each must write its PNG and launch its kernels; host seconds each."""
    import cv2

    from impx_torch import demo

    total, failures = dict.fromkeys(kernels, 0), []
    gen = torch.Generator().manual_seed(43)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = image_pairs(gen, "cpu", 1, *SCANNET_HW)
        paths = [f"{tmp}/image0.png", f"{tmp}/image1.png"]
        for path, img in zip(paths, (a, b)):
            cv2.imwrite(path, (img[0, 0].numpy() * 255).round().astype(np.uint8))
        torch.save(SuperPoint(device="cpu", seed=2).state_dict(), f"{tmp}/superpoint_v1.pth")
        imp = {"mha_fused": 30, "sinkhorn_fused_stats": 1}
        eimp = {"mha_fused": 30 - 2 * eimp_pools, "mha_fused_lse": 2 * eimp_pools,
                "attention_key_mass": 2 * eimp_pools, "sinkhorn_fused_stats": 15}
        for label, flags, want in (("spp IMP", ["--feature", "spp"], imp), ("sift IMP", ["--feature", "sift"], imp),
                                   ("sift EIMP", ["--feature", "sift", "--matching_method", "EIMP"], eimp)):
            out_png = f"{tmp}/{label.replace(' ', '_')}.png"
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            out = demo.main(["--image0", paths[0], "--image1", paths[1], *flags, "--fx", str(DEMO_FX),
                             "--sp_weights", f"{tmp}/superpoint_v1.pth", "--output", out_png, "--device", str(dev)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}
            for k, v in launches.items():
                total[k] += v
            size = os.path.getsize(out_png) if os.path.isfile(out_png) else 0
            say(f"frontend demo {label}: features {out['features']}, matches {len(out['matches'])}, pose inliers "
                f"{None if out['inliers'] is None else int(out['inliers'].sum())}, PNG {size} bytes, launches "
                f"{launches}, host {seconds:.2f} s")
            if not size or launches != {**dict.fromkeys(kernels, 0), **want}:
                failures.append(f"the demo ({label}) wrote no PNG or did not launch its kernels")
    return {"launches": total, "failures": failures}


def planted_views(rs, n: int):
    """Two views of n keypoints each, half of view 2 the reprojection of
    view 1's (0.5 px noise, depths consistent for the cycle check)."""
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    poses = []
    for _ in range(2):
        axis = rs.randn(3) * 0.1                      # a rotation of about 0.1 rad (Rodrigues' formula)
        theta = np.linalg.norm(axis)
        kx = np.cross(np.eye(3), axis / theta)
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx
        T[:3, 3] = rs.randn(3) * 0.1
        poses.append(T)
    pos1, pos2 = rs.rand(n, 2) * [640, 480], rs.rand(n, 2) * [640, 480]
    depth1, depth2 = rs.uniform(2, 10, n), rs.uniform(2, 10, n)
    m = n // 2
    X = np.concatenate([(pos1[:m] + 0.5 - K[:2, 2]) * depth1[:m, None] / K[0, 0], depth1[:m, None],
                        np.ones((m, 1))], axis=1)
    X2 = (poses[1] @ np.linalg.inv(poses[0]) @ X.T).T
    pos2[:m] = X2[:, :2] / X2[:, 2:3] * K[0, 0] + K[:2, 2] - 0.5 + rs.randn(m, 2) * 0.5
    depth2[:m] = X2[:, 2]
    return pos1, depth1, K, poses[0], pos2, depth2, K, poses[1]


def check_reprojection(dev) -> list[str]:
    """Phase 19 (e): match_from_projection_points on the card at REPROJ_N
    keypoints a side against the CPU: equal labels, and its ms."""
    from impx_torch.geometry.reprojection import match_from_projection_points

    views = planted_views(np.random.RandomState(44), REPROJ_N)
    on = lambda d: [torch.as_tensor(np.asarray(a, np.float32), device=d) for a in views]  # noqa: E731
    kw = dict(inlier_th=5.0, outlier_th=15.0, cycle_check=True)   # dump_megadepth.py's thresholds
    m_cpu, o_cpu = match_from_projection_points(*on("cpu"), **kw)
    card = on(dev)
    m_card, o_card = match_from_projection_points(*card, **kw)
    equal = torch.equal(m_card.cpu(), m_cpu) and torch.equal(o_card.cpu(), o_cpu)
    ms = cuda_ms(lambda *a: match_from_projection_points(*a, **kw), [card])
    say(f"frontend match_from_projection_points {REPROJ_N} x {REPROJ_N} card vs CPU: labels equal {equal}, "
        f"matches {int((m_card >= 0).sum())} (planted {REPROJ_N // 2}), {ms:.3f} ms on the card")
    return [] if equal and int((m_card >= 0).sum()) > REPROJ_N // 4 else ["match_from_projection_points: the card's "
                                                                         "labels differ from the CPU's"]


def frontend_path(dev, kernels, DGNNS, MatcherConfig, load_reference_state_dict) -> dict:
    """Phase 19: SuperPoint's checks (a) and times (b), the ScanNet protocol
    end to end (c), the demo CLI (d), the depth reprojection labels (e); the
    dumps write HDF5 and are held on the CPU only (f). Returns the kernel
    launches over its kernel-path runs: (c)'s checked call and (d)'s runs."""
    from impx_torch.models.fast import _eimp_do_pool
    from impx_torch.models.superpoint import (
        SuperPoint, _conv, backbone, compare_extractions, ieee_fp32_convs, sample_descriptors, simple_nms, top_k)

    t_phase = time.perf_counter()
    failures = check_superpoint(dev, SuperPoint, compare_extractions, ieee_fp32_convs, _conv)
    sp_model = time_superpoint(dev, SuperPoint, (backbone, simple_nms, top_k, sample_descriptors))
    e2e = scannet_e2e(dev, sp_model, DGNNS, MatcherConfig, load_reference_state_dict, kernels)
    demo = demo_runs(dev, SuperPoint, kernels, sum(_eimp_do_pool(MatcherConfig.eval_config("sift", 15))))
    failures += e2e["failures"] + demo["failures"] + check_reprojection(dev)
    say(f"frontend (f): the YFCC, ScanNet and MegaDepth dumps write HDF5 (h5py here: "
        f"{importlib.util.find_spec('h5py') is not None}); they are held against impx on the CPU "
        f"(tests/test_torch_dump.py) and not run here")
    total = {k: e2e["launches"][k] + demo["launches"][k] for k in kernels}
    say(f"frontend phase {time.perf_counter() - t_phase:.1f} s; kernel launches over its kernel-path runs {total}")
    if failures:
        fail("; ".join(failures))
    return total


# ---------------------------------------------------------------- phase 20: the queue loops
# impx's three on-device loops (impx_torch/eval/iterative_{fused,refill,staged}.py)
# at bench_suite.py's iterative cells (:1103-1140): eval_config('spp', 15) bf16,
# 2048 keypoints, 64 pairs a queue, 16 in flight, 256 minimal sets, threshold
# 2e-3. At random weights a pair stops only if its descriptors carry the
# match (EVAL_DESC_SCALE); half the queue has no true correspondence and runs
# every layer.
QUEUE_PAIRS, QUEUE_IN_FLIGHT, QUEUE_KPT = 64, 16, 2048
QUEUE_INLIER_FRAC = 0.25
QUEUE_THRESH, QUEUE_HYPOTHESES = 2e-3, 256
QUEUE_PERMUTED_AGREE = 0.99       # indices0 of valid rows, a queue loop against itself on the permuted queue
QUEUE_CHECK_PAIRS = 16            # check (d): fp32, kernel against plain path
QUEUE_STOPS_EQUAL_MIN = 15        # of QUEUE_CHECK_PAIRS
QUEUE_AGREE_MIN = 0.99            # indices0 on pairs with equal stops
QUEUE_POSE_DEG = 0.5              # converged pairs with equal stops
QUEUE_KERNELS = ("mha_fused", "sinkhorn_fused_stats", "attention_key_mass")


def queue_feed(dev, pairs: int, seed: int) -> dict:
    """`pairs` pairs from synthesize_feed_device, matchable ones
    (QUEUE_INLIER_FRAC) and ones with no true correspondence alternating,
    descriptors x EVAL_DESC_SCALE, norm_threshs QUEUE_THRESH."""
    from impx_torch.data.synthetic_device import synthesize_feed_device

    gen = torch.Generator(device=dev).manual_seed(seed)
    half = [synthesize_feed_device(gen, pairs // 2, QUEUE_KPT, D, inlier_frac=frac, device=dev)[0]
            for frac in (QUEUE_INLIER_FRAC, 0.0)]
    feed = {k: torch.stack([half[0][k], half[1][k]], 1).flatten(0, 1) for k in half[0]}
    for k in ("descriptors0", "descriptors1"):
        feed[k] = feed[k] * EVAL_DESC_SCALE
    feed["norm_threshs"] = torch.full((pairs,), QUEUE_THRESH, device=dev)
    return feed


def batches_of(feed: dict, size: int) -> list[dict]:
    return [{k: v[i:i + size] for k, v in feed.items()} for i in range(0, len(feed["norm_threshs"]), size)]


def lockstep(loop):
    """A lockstep loop over the queue in batches of QUEUE_IN_FLIGHT: each
    batch's outputs concatenated, its counters summed."""
    def run(feed):
        outs = [loop(b) for b in batches_of(feed, QUEUE_IN_FLIGHT)]
        out = {k: torch.cat([o[k] for o in outs]) for k in ("indices0", "R", "t", "converged", "stopped_at")}
        for k in ("n_steps", "checkpoints", "host_reads"):
            out[k] = sum(o[k] for o in outs) if k in outs[0] else None
        return out
    return run


def queue_run(label, run, feed, kernels) -> dict:
    """One timed run over the queue (host clock, ending in a copy of the
    outputs to the host) with every launch count set to 0 just before and
    read just after: pairs/s, the stop histogram, the loop's counters."""
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(feed)
    host = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
    seconds = time.perf_counter() - t0
    host["launches"] = {k: kernels[k].launches for k in QUEUE_KERNELS}
    host["pairs_per_s"] = len(feed["norm_threshs"]) / seconds
    stops = host["stopped_at"].tolist()
    host["histogram"] = dict(sorted(collections.Counter(stops).items()))
    say(f"queue {label}: {len(stops)} pairs in {seconds:.3f} s = pairs_per_s {host['pairs_per_s']:.2f} (host clock, "
        f"outputs copied to the host); stops {host['histogram']}; converged {int(host['converged'].sum())}; "
        f"n_steps {host['n_steps']}, layer steps {host.get('layer_steps', host['n_steps'])}, checkpoints "
        f"{host['checkpoints']}, host reads {host['host_reads']}, completed {host.get('completed', len(stops))}; "
        f"launches {host['launches']}")
    if not bool(torch.isfinite(host["R"]).all() and torch.isfinite(host["t"]).all()):
        fail(f"queue {label}: non-finite poses")
    return host


def queue_profile(label, run, feed) -> dict:
    """One run under torch.profiler with the device activity alone, read from
    the raw trace (a queue's run holds a few hundred thousand device
    operations; with the host's events beside them, recording and reading
    the trace took minutes): device busy, the idle share of the window from
    the first to the last device operation, device operations, and the
    device ms of each kernel group. Returns the run's output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run(feed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    results = getattr(prof.profiler, "kineto_results", None)
    events = [] if results is None else [e for e in results.events() if e.device_type() == DeviceType.CUDA]
    if not events:
        say(f"profile queue {label}: the profiler recorded no device events; busy and idle not measured")
        return out
    other = "other PyTorch kernels (norm, elementwise, copies)"
    groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + [other], 0)
    spans = []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        name = e.name()
        groups[next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), other)] += dur
    spans.sort()
    busy, end = 0, spans[0][0]
    for s, e in spans:                       # union of operation intervals, ns
        busy += max(0, e - max(s, end))
        end = max(end, e)
    say(f"profile queue {label}: host wall {1e3 * wall:.3f} ms, device busy {busy / 1e6:.3f} ms, idle share "
        f"{1 - busy / (spans[-1][1] - spans[0][0]):.3f} of the window, {len(events)} device operations; by group "
        + ", ".join(f"{g.split(' (')[0]} {t / 1e6:.3f} ms" for g, t in groups.items() if t))
    return out


def compare_paths(label, kernel, plain, valid0) -> list[str]:
    """Check (d): equal stops on QUEUE_STOPS_EQUAL_MIN pairs, indices0
    agreement on pairs with equal stops, poses of converged pairs with equal
    stops within QUEUE_POSE_DEG."""
    same = kernel["stopped_at"] == plain["stopped_at"]
    agree = (kernel["indices0"] == plain["indices0"])[same[:, None] & valid0].float().mean().item()
    both = same & kernel["converged"] & plain["converged"]
    deg = pose_diff64(kernel["R"][both], kernel["t"][both], plain["R"][both], plain["t"][both])
    worst = deg.max().item() if len(deg) else 0.0
    say(f"queue (d) {label}: equal stops on {int(same.sum())} of {len(same)} pairs (min {QUEUE_STOPS_EQUAL_MIN}); "
        f"kernel stops {kernel['stopped_at'].tolist()}, plain {plain['stopped_at'].tolist()}; indices0 agreement "
        f"{agree:.4f} (min {QUEUE_AGREE_MIN}) on them; pose difference at most {worst:.4f} deg over {int(both.sum())} "
        f"converged pairs (max {QUEUE_POSE_DEG})")
    bad = []
    if int(same.sum()) < QUEUE_STOPS_EQUAL_MIN or agree < QUEUE_AGREE_MIN or worst > QUEUE_POSE_DEG:
        bad.append(f"(d) {label}: the kernel path disagrees with the plain path")
    return bad


def queue_loops_path(dev, kernels, DGNNS, AdaGMN, MatcherConfig, load_reference_state_dict) -> dict:
    """Phase 20: the lockstep loop (4 batches of 16, and with uncertainty on
    AdaGMN), slot refill at 16 slots, staged cohorts at 16, and
    BatchedIterativeMatcher for scale, on one 64-pair queue at bf16; checks
    (a) varied stops, (b) every pair completed, (c) refill and staged on the
    permuted queue (the profiled runs), (d) each loop at fp32 on the kernel
    path against the plain path on 16 pairs. Returns the kernel launches
    over the phase's kernel-path runs."""
    from impx_torch.eval.evaluator import pair_generator
    from impx_torch.eval.iterative import BatchedIterativeMatcher
    from impx_torch.eval.iterative_fused import run_iterative_fused
    from impx_torch.eval.iterative_refill import run_iterative_refill
    from impx_torch.eval.iterative_staged import run_iterative_staged

    t_phase = time.perf_counter()
    kw = dict(num_hypotheses=QUEUE_HYPOTHESES)
    cfg = MatcherConfig.eval_config("spp", 15)

    def models(dtype):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        return (carried_model(DGNNS, c, dev, reference_layout, load_reference_state_dict),
                carried_model(AdaGMN, c, dev, reference_layout, load_reference_state_dict,
                              randomize=lambda m: m.bin_score.data.fill_(ITER_EIMP_BIN_SCORE)))

    def runners(imp, eimp):
        bim = BatchedIterativeMatcher(imp, norm_thresh=QUEUE_THRESH, num_hypotheses=QUEUE_HYPOTHESES)
        return {
            "fused": lockstep(lambda b: run_iterative_fused(imp, b, 1, b["norm_threshs"], **kw)),
            "fused uncertainty": lockstep(lambda b: run_iterative_fused(eimp, b, 1, b["norm_threshs"],
                                                                        with_uncertainty=True, **kw)),
            "refill": lambda q: run_iterative_refill(imp, q, 1, slots=QUEUE_IN_FLIGHT, **kw),
            "staged": lambda q: run_iterative_staged(imp, q, 1, batch=QUEUE_IN_FLIGHT, **kw),
            "BatchedIterativeMatcher": lockstep(lambda b: bim.run_batch(
                b, [pair_generator(dev, 1, i) for i in range(len(b["norm_threshs"]))], b["norm_threshs"])),
        }

    imp, eimp = models("bfloat16")
    say(f"queue loops: eval_config('spp', 15) bf16, {QUEUE_PAIRS} pairs of {QUEUE_KPT} keypoints "
        f"(synthesize_feed_device, inlier_frac {QUEUE_INLIER_FRAC} and 0 alternating, descriptors x{EVAL_DESC_SCALE}), "
        f"{QUEUE_IN_FLIGHT} in flight, {QUEUE_HYPOTHESES} minimal sets, threshold {QUEUE_THRESH}")
    feed = queue_feed(dev, QUEUE_PAIRS, 21)
    total = dict.fromkeys(kernels, 0)
    failures, runs = [], {}
    # each loop once (twice in turns, A B C D E E D C B A, before phase 23 took
    # the script's time: the first run of the phase pays one-time costs, and
    # the host's pace drifts between runs)
    for label, run in runners(imp, eimp).items():
        out = queue_run(label, run, feed, kernels)
        for k, n in out["launches"].items():
            total[k] += n
        runs[label] = out
        if label == "BatchedIterativeMatcher":   # the plain Sinkhorn plan at its checkpoints
            ok = out["launches"]["mha_fused"] > 0 and out["launches"]["sinkhorn_fused_stats"] == 0
        else:
            ok = (out["launches"]["mha_fused"] == 2 * out.get("layer_steps", out["n_steps"])
                  and out["launches"]["sinkhorn_fused_stats"] == out["checkpoints"]
                  and out["launches"]["attention_key_mass"] == (2 * out["checkpoints"] if "uncertainty" in label
                                                                else 0))
        if not ok:
            failures.append(f"{label}: launches {out['launches']} do not match its layer steps and checkpoints")
        if label in ("fused", "refill", "staged") and len(out["histogram"]) < 2:
            failures.append(f"(a) {label}: every pair stopped at the same iteration {out['histogram']}")
        if label in ("refill", "staged") and out["completed"] != QUEUE_PAIRS:
            failures.append(f"(b) {label}: completed {out['completed']} of {QUEUE_PAIRS}")
    say("queue pairs_per_s, one run each: " + "; ".join(f"{label} {v['pairs_per_s']:.2f}" for label, v in runs.items()))

    # (c) the profiled runs: refill and staged on the permuted queue, the others on one batch
    perm = torch.randperm(QUEUE_PAIRS, generator=torch.Generator().manual_seed(22)).to(dev)
    permuted = {k: v[perm] for k, v in feed.items()}
    permuted["pair_ids"] = perm
    inv = torch.argsort(perm).cpu()
    valid0 = feed["valid0"].cpu()
    for label, run in runners(imp, eimp).items():
        queue = permuted if label in ("refill", "staged") else batches_of(feed, QUEUE_IN_FLIGHT)[0]
        out = queue_profile(label, run, queue)
        if label not in ("refill", "staged"):
            continue
        p = {k: v.cpu()[inv] for k, v in out.items() if isinstance(v, torch.Tensor)}
        a = runs[label]
        same_stop = torch.equal(p["stopped_at"], a["stopped_at"]) and torch.equal(p["converged"], a["converged"])
        agree = (p["indices0"] == a["indices0"])[valid0].float().mean().item()
        bitwise = sum(all(torch.equal(p[k][i], a[k][i]) for k in ("indices0", "R", "t")) for i in range(QUEUE_PAIRS))
        say(f"queue (c) {label} on the permuted queue: equal stopped_at and converged on every pair {same_stop}; "
            f"indices0 agreement {agree:.4f} (min {QUEUE_PERMUTED_AGREE}) over valid rows; {bitwise} of {QUEUE_PAIRS} "
            f"pairs bitwise equal (indices0, R, t)")
        if not same_stop or agree < QUEUE_PERMUTED_AGREE:
            failures.append(f"(c) {label}: the permuted queue changes the results")
    del imp, eimp

    # (d) fp32, each loop on the kernel path against the plain path
    imp, eimp = models("float32")
    small = queue_feed(dev, QUEUE_CHECK_PAIRS, 23)
    small_valid0 = small["valid0"].cpu()
    for label, run in runners(imp, eimp).items():
        if label == "BatchedIterativeMatcher":
            continue
        for fn in kernels.values():
            fn.launches = 0
        with counting_inference_plain_bodies() as plain_calls:
            kernel = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in run(small).items()}
        launches = {k: kernels[k].launches for k in QUEUE_KERNELS}
        bodies = sum(n for counts in plain_calls for n in counts.values())
        for k, n in launches.items():
            total[k] += n
        for m in (imp, eimp):
            m.use_kernels = False
        for fn in kernels.values():
            fn.launches = 0
        plain = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in run(small).items()}
        plain_launches = sum(kernels[k].launches for k in QUEUE_KERNELS)
        for m in (imp, eimp):
            m.use_kernels = True
        say(f"queue (d) {label} float32: kernel path launches {launches}, plain bodies called on it {bodies}; "
            f"plain path launches {plain_launches}")
        if (bodies or plain_launches or not launches["mha_fused"] or not launches["sinkhorn_fused_stats"]
                or ("uncertainty" in label) != bool(launches["attention_key_mass"])):
            failures.append(f"(d) {label}: the kernel path did not run through the kernels alone")
        failures += compare_paths(f"{label} float32", kernel, plain, small_valid0)
    say(f"queue loops phase {time.perf_counter() - t_phase:.1f} s; kernel launches over its kernel-path runs {total}")
    if failures:
        fail("; ".join(failures))
    return total


# ---------------------------------------------------------------- phase 21: the training CLI
CLI_N1 = 768                      # image 1's keypoints at N0 != N1 (GM's unrolled step, kernels 3 and 5)
# kernels 3 and 5 (and 4) at Nq != Nk: 16 pairs x 1024 queries against 768
# keys, and a ragged shape with a fully masked batch, each at bf16 and fp32
NK_CHECK_SHAPES = tuple((dtype, shape) for shape in (dict(nk=CLI_N1), dict(b=3, h=2, n=333, dh=32, nk=290))
                        for dtype in (torch.bfloat16, torch.float32))
CLI_CONFIG = "configs/config_train_megadepth.json"
CLI_STEPS = 5                     # steps a CLI run: one warm-up, three timed, one profiled (6 before phase 23)
ATTN_A = {"mha_fused": 30, "mha_bwd": 30}
LOG_OT = {**ATTN_A, "log_sinkhorn_fused_stats": 15}
CLI_RUNS = (("base", (), ATTN_A), ("premade samples", (), ATTN_A), ("gm", ("--network", "gm"), ATTN_A),
            ("log_ot", ("--log_ot",), LOG_OT),
            ("dual softmax", ("--with_sinkhorn", "0"), ATTN_A), ("with_geo", ("--with_geo",), ATTN_A),
            ("train_fused", ("--train_fused",), {"mha_fused_lse": 30, "mha_bwd_from_lse": 30}))


class PremadeSamples:
    """The first n samples of a dataset, made before the run: the trainer's
    data thread then only stacks them (the "premade samples" run, which
    takes the samples' making out of the step's way)."""

    def __init__(self, dataset, n: int):
        self.samples = [dataset[i] for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


def cut_train_batch(data, m):
    """A training batch with image 1 cut to its first m keypoints: image-0
    rows matched beyond m go to the dustbin column."""
    out = {k: (x[:, :m] if k in ("descriptors1", "norm_keypoints1", "scores1", "valid1") else x)
           for k, x in data.items()}
    gt = data["matching_mask"]
    n1 = gt.shape[2] - 1
    cut = torch.cat([gt[:, :, :m], gt[:, :, n1:]], dim=2)
    cut[:, :-1, m] = torch.clamp(cut[:, :-1, m] + gt[:, :-1, m:n1].sum(2), max=1.0)
    out["matching_mask"] = cut
    return out


def cli_step_checks(dev, DGNNS, GM, MatcherConfig, kernels, ka, log_module) -> None:
    """Phase 21 (b): one step, kernel path against plain path, of GM's
    unrolled training forward at the published shape (16 pairs x 1024, 15
    layers, fp32) and at 1024 / 768, and of DGNNS under the log-OT head and
    with the dual softmax."""
    gen = torch.Generator().manual_seed(21)
    batch = train_pairs(gen, dev, TB, TN)
    base = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="float32")
    plain = ((ka, PLAIN_BODIES), (log_module, ("log_sinkhorn_stats_reference",)))
    cases = (("GM.forward_train", GM, base, batch, ATTN_A),
             (f"GM.forward_train {TN} / {CLI_N1}", GM, base, cut_train_batch(batch, CLI_N1),
              {"mha_fused": 60, "mha_bwd": 60}),
             ("DGNNS log_ot", DGNNS, dataclasses.replace(base, log_ot=True), batch, LOG_OT),
             ("DGNNS dual softmax", DGNNS, dataclasses.replace(base, with_sinkhorn=False), batch, ATTN_A))
    for label, cls, cfg, data, want in cases:
        model = cls(cfg, device=dev, seed=0)
        step_check(label, model, data, want, kernels, plain)
        del model


def device_busy(prof) -> tuple[float, int] | None:
    """(ms the device was busy, the union of its operations, and their
    count) from a profiler run with device activity; None without
    device events."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    events = [] if results is None else [e for e in results.events() if e.device_type() == DeviceType.CUDA]
    if not events:
        return None
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events)
    busy, end = 0, spans[0][0]
    for s, e in spans:
        busy += max(0, e - max(s, end))
        end = max(end, e)
    return busy / 1e6, len(events)


def training_cli_path(dev, kernels, ka, runs=CLI_RUNS, resume: bool = True, plain=PLAIN_BODIES,
                      label: str = "train cli") -> dict:
    """Phase 21 (c): the training CLI in process, `main([...])`, at the
    published config on --synthetic, CLI_STEPS steps a run (`runs`: base;
    base with its samples made before the run; gm, --log_ot, --with_sinkhorn
    0, --with_geo, --train_fused), then, with `resume`, a resume from the
    base run's checkpoint. Trainer.step_fn is timed by wrapping
    make_train_step here (synchronised before and after); the last step of a
    run runs under the profiler (device activity only) for the device's
    idle share of the step; the plain bodies `plain` of `ka` must not be
    called. Returns the kernel launches over the runs."""
    import shutil
    import signal

    from torch.profiler import ProfilerActivity, profile

    from impx_torch.train import train as cli
    from impx_torch.train import trainer as trainer_module

    root = os.path.dirname(os.path.abspath(__file__))
    runs_dir = os.path.join(root, "impx_torch", "_build", "train_cli_runs")
    shutil.rmtree(runs_dir, ignore_errors=True)
    sigterm = signal.getsignal(signal.SIGTERM)
    record = {"spans": [], "idle": None}
    real_make = trainer_module.make_train_step
    real_build = cli.build_dataset

    def timed_make_train_step(model, hp):
        step = real_make(model, hp)

        def timed(*args):
            torch.cuda.synchronize()
            last = len(record["spans"]) == CLI_STEPS - 1
            with profile(activities=[ProfilerActivity.CUDA]) if last else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            record["spans"].append((t0, t1))
            if last:
                busy = device_busy(prof)
                record["idle"] = None if busy is None else (1 - busy[0] / (1e3 * (t1 - t0)), busy[1], 1e3 * (t1 - t0))
            return out
        return timed

    base = ["--config", os.path.join(root, CLI_CONFIG), "--synthetic", "--epochs", "1",
            "--its_per_epoch", str(CLI_STEPS), "--log_intervals", "1"]
    total = dict.fromkeys(kernels, 0)
    failures, base_ckpt = [], None
    t_phase = time.perf_counter()
    trainer_module.make_train_step = timed_make_train_step
    try:
        for run, extra, want in runs + ((("resume", None, ATTN_A),) if resume else ()):
            argv = ([*base, *extra] if extra is not None else
                    [*base, "--epochs", "2", "--resume_path", base_ckpt])
            argv += ["--save_path", os.path.join(runs_dir, run.replace(" ", "_"))]
            cli.build_dataset = ((lambda args: PremadeSamples(real_build(args), CLI_STEPS * TB))
                                 if run == "premade samples" else real_build)
            for fn in kernels.values():
                fn.launches = 0
            record["spans"], record["idle"] = [], None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with counting_plain_bodies(ka, plain) as plain_calls:
                trainer = cli.main(argv)
            signal.signal(signal.SIGTERM, sigterm)   # the Trainer's handler only sets a flag
            peak = torch.cuda.max_memory_allocated() / 2**30
            spans = record["spans"]
            launches = {k: fn.launches for k, fn in kernels.items()}
            for k, n in launches.items():
                total[k] += n
            per_step = {k: n / max(len(spans), 1) for k, n in launches.items() if n}
            steps_ms = [1e3 * (b - a) for a, b in spans]
            med = statistics.median(steps_ms[1:-1])
            loop = TB * (len(spans) - 2) / (spans[-2][1] - spans[0][1])   # step 1 to the last timed step
            with open(os.path.join(trainer.save_dir, "metrics.jsonl")) as f:
                losses = [json.loads(line)["loss"] for line in f]
            ckpt = os.path.join(trainer.save_dir, f"{trainer.args.network}.{trainer.epoch - 1:02d}")
            idle = record["idle"]
            say(f"{label} {run}: {len(spans)} steps, median {med:.1f} ms a step (Trainer.step_fn between two "
                f"synchronisations, steps 1-{len(spans) - 2}; all steps ms {[round(t, 1) for t in steps_ms]}) = "
                f"train_pairs_per_s {TB / (med / 1e3):.2f}; the loop, data waits included, {loop:.2f} pairs/s; peak device "
                f"memory {peak:.2f} GiB; idle share of the profiled step "
                + (f"{idle[0]:.3f} ({idle[1]} device operations in {idle[2]:.1f} ms)" if idle else "not measured")
                + f"; kernel launches a step {per_step}; plain bodies called {dict(plain_calls)}; losses "
                f"{[round(x, 5) for x in losses]}; epoch {trainer.epoch}, checkpoint {os.path.basename(ckpt)} "
                f"written {os.path.isfile(ckpt)}")
            if (len(spans) != CLI_STEPS or per_step != {k: float(n) for k, n in want.items()}
                    or any(plain_calls.values())):
                failures.append(f"{run}: {len(spans)} steps, launches a step {per_step}, plain bodies {plain_calls}")
            if len(losses) != CLI_STEPS or not all(np.isfinite(losses)) or not os.path.isfile(ckpt):
                failures.append(f"{run}: losses {losses}, checkpoint {ckpt}")
            if extra is None and (trainer.epoch != 2 or trainer.iteration != 2 * CLI_STEPS
                                  or os.path.isfile(ckpt[:-2] + "00")):
                failures.append(f"resume: epoch {trainer.epoch}, iteration {trainer.iteration}: it did not start "
                                f"at epoch 1 from the base run's checkpoint")
            if run == "base":
                base_ckpt = ckpt
            trainer.writer.close()
            del trainer
            torch.cuda.empty_cache()
    finally:
        trainer_module.make_train_step = real_make
        cli.build_dataset = real_build
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(runs_dir, ignore_errors=True)
    say(f"{label} phase {time.perf_counter() - t_phase:.1f} s; kernel launches over its runs "
        f"{ {k: n for k, n in total.items() if n} }")
    if failures:
        fail(f"{label}: " + "; ".join(failures))
    return total


def training_cli_phase(dev, kernels, ka, DGNNS, MatcherConfig) -> dict:
    """Phase 21: (a) kernels 3 and 5 (and 4) at Nq != Nk against their plain
    versions, (b) the step checks, (c) the training CLI. Returns the kernel
    launches of (c)."""
    from impx_torch.models.gm import GM
    from impx_torch.ops.kernels import log_sinkhorn as log_module

    t_phase = time.perf_counter()
    check_training_kernels(dev, ka, NK_CHECK_SHAPES)
    cli_step_checks(dev, DGNNS, GM, MatcherConfig, kernels, ka, log_module)
    say(f"train cli checks (a) and (b) {time.perf_counter() - t_phase:.1f} s")
    return training_cli_path(dev, kernels, ka)


# ---------------------------------------------------------------- phase 22: EIMP training, batch norm in train mode
# bench_suite.py:1203-1206 (train_step_1024_eimp_compact): half the keypoints
# before iteration 4, a quarter before iteration 8
EIMP_TRAIN_COMPACTION = ((4, 512), (8, 256))
EIMP_TRAIN_BIN_SCORE = EIMP_BIN_SCORE   # pooling drops about 40% of 1024 at random weights
EIMP_LOSS_RTOL, EIMP_COS_MIN = 1e-4, 0.9999   # fp32, kernel path vs plain path
ATTN_MASS = {**ATTN_A, "attention_key_mass": 12}   # 6 pooling iterations x 2 mass calls
ATTN_SPLIT_MASS = {"mha_fused": 60, "mha_bwd": 60, "attention_key_mass": 12}   # one launch an image
SG_TRAIN = {"mha_fused": 2 * SG_LAYERS, "mha_bwd": 2 * SG_LAYERS, "log_sinkhorn_fused_stats": SG_LAYERS}
EIMP_PLAIN = PLAIN_BODIES + ("attention_key_mass_reference", "attention_key_mass_from_lse_reference")
EIMP_CLI_RUNS = (("adagmn", ("--network", "adagmn"), ATTN_MASS),
                 ("adagmn compacted", ("--network", "adagmn", "--train_compaction",
                                       ",".join(f"{it}:{k}" for it, k in EIMP_TRAIN_COMPACTION)), ATTN_MASS),
                 ("dgnns bn", ("--norm_fn", "bn"), ATTN_A),
                 ("adagmn bn", ("--network", "adagmn", "--norm_fn", "bn"), ATTN_SPLIT_MASS))


def bn_layers_zero_grad_leaves(model) -> re.Pattern:
    """The leaves whose exact gradient is 0 when only the keypoint encoder
    normalises from batch statistics and the layers from running statistics
    (which keep a shift): the encoder's biases before its norms, k's bias."""
    last = len(model.kenc.blocks) - 1
    return re.compile(rf"(kenc\.blocks\.[0-{last - 1}]\.bias|attn\.k\.bias)$")


def recording_keeps(model):
    """Record the keep counts a pool leaves ([B] each image), in model.keeps."""
    model.keeps = []
    pool = model._pool_from_masses

    def recorded(*args):
        keep0, keep1 = pool(*args)
        model.keeps.append((keep0.sum(1), keep1.sum(1)))
        return keep0, keep1

    model._pool_from_masses = recorded
    return model


def eimp_step_checks(dev, AdaGMN, DGNNS, SuperGlue, MatcherConfig, kernels, ka) -> dict:
    """Phase 22 (a): one step, kernel path against plain path, at the
    published training config (15 layers, 1024 keypoints, batch 16, fp32) of
    AdaGMN's masked and compacted training scans, DGNNS and AdaGMN under
    batch norm (random statistics), and SuperGlue at its published widths:
    launches, no plain body on the kernel path, loss within EIMP_LOSS_RTOL,
    cosines above EIMP_COS_MIN, the keep counts of every pool beside the
    plain path's. Returns the launches over the kernel-path steps."""
    from impx_torch.models import adgm as adgm_module
    from impx_torch.ops.kernels import log_sinkhorn as log_module
    from impx_torch.ops.kernels import sinkhorn as sink_module

    gen = torch.Generator().manual_seed(22)
    batch = train_pairs(gen, dev, TB, TN)
    base = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="float32")
    bn = dataclasses.replace(base, norm_fn="bn")
    plain = ((ka, EIMP_PLAIN), (adgm_module, ("attention_key_mass_reference",)),
             (sink_module, ("sinkhorn_stats_reference",)), (log_module, ("log_sinkhorn_stats_reference",)))
    sg_cfg = dataclasses.replace(bn, n_layers=SG_LAYERS, sinkhorn_iterations=SG_ITERS)
    cases = (("AdaGMN masked", AdaGMN, base, ATTN_MASS),
             (f"AdaGMN compacted {EIMP_TRAIN_COMPACTION}", AdaGMN,
              dataclasses.replace(base, train_compaction=EIMP_TRAIN_COMPACTION), ATTN_MASS),
             ("DGNNS bn", DGNNS, bn, ATTN_A), ("AdaGMN bn", AdaGMN, bn, ATTN_SPLIT_MASS),
             ("SuperGlue", SuperGlue, sg_cfg, SG_TRAIN))
    total = dict.fromkeys(kernels, 0)
    for label, cls, cfg, want in cases:
        model = cls(cfg, device=dev, seed=0)
        if cls is AdaGMN:
            recording_keeps(model)
            with torch.no_grad():
                model.bin_score.fill_(EIMP_TRAIN_BIN_SCORE)
        if cfg.norm_fn == "bn":
            randomize_batch_norm(model, gen)
        zero = bn_layers_zero_grad_leaves(model) if cls is not AdaGMN and cfg.norm_fn == "bn" else None
        torch.cuda.reset_peak_memory_stats()
        launches = step_check(label, model, batch, want, kernels, plain, EIMP_LOSS_RTOL, EIMP_COS_MIN, zero)
        for k, n in launches.items():
            total[k] += n
        keeps = getattr(model, "keeps", [])
        half = len(keeps) // 2
        if keeps:
            summed = [[(int(a.sum()), int(b.sum())) for a, b in part] for part in (keeps[:half], keeps[half:])]
            diff = max(int((a - c).abs().max().item()) + int((b - d).abs().max().item())
                       for (a, b), (c, d) in zip(keeps[:half], keeps[half:]))
            say(f"train eimp {label}: keep counts after each pool summed over the {TB} pairs "
                f"(image 0, image 1), kernel path {summed[0]}; plain path {summed[1]}; valid "
                f"({int(batch['valid0'].sum())}, {int(batch['valid1'].sum())}); largest difference of a pair's "
                f"count between the paths {diff}")
        extra = {}
        if cfg.train_compaction:
            with torch.no_grad():
                out = model.forward_train(batch)
            extra = {k: out[k].item() for k in ("compaction_overflow0", "compaction_overflow1")}
        say(f"train eimp {label}: batch {TB}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" + (f", overflow {extra}" if extra else ""))
        del model
        torch.cuda.empty_cache()
    return total


def eimp_step_times(dev, AdaGMN, MatcherConfig, TrainHyperParams, make_train_step, init_opt_state,
                    init_stats, steps: int = 4) -> None:
    """Phase 22 (b): make_train_step of AdaGMN masked and compacted
    (EIMP_TRAIN_COMPACTION) at the published config, fp32, the CLI's random
    weights: `steps` synchronised steps each on fresh batches, in turns
    (masked, compacted, compacted, masked), then one step each under a
    device-only profile (busy ms, idle share, operations). Separates the
    step from the CLI's data thread."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(23)
    batches = [train_pairs(gen, dev, TB, TN) for _ in range(steps)]
    base = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="float32")
    models = {"masked": AdaGMN(base, device=dev, seed=0),
              "compacted": AdaGMN(dataclasses.replace(base, train_compaction=EIMP_TRAIN_COMPACTION),
                                  device=dev, seed=0)}
    state = {k: (make_train_step(m, TrainHyperParams()), init_opt_state(m), init_stats(dev))
             for k, m in models.items()}
    times = {k: [] for k in models}
    for name in ("masked", "compacted", "compacted", "masked"):
        step, opt, stats = state[name]
        for it, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(opt, it, batch, stats)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    for name, (step, opt, stats) in state.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(opt, steps, batches[0], stats)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        busy = device_busy(prof)
        ts = times[name][1:]   # the first step of the first turn warms up
        say(f"train eimp make_train_step {name}: median {statistics.median(ts):.1f} ms a step over "
            f"{len(ts)} steps in turns (all {[round(t, 1) for t in times[name]]}); profiled step {wall:.1f} ms, "
            + (f"device busy {busy[0]:.3f} ms, idle share {1 - busy[0] / wall:.3f}, {busy[1]} device operations"
               if busy else "no device events"))


def eimp_training_phase(dev, kernels, ka, AdaGMN, DGNNS, SuperGlue, MatcherConfig) -> dict:
    """Phase 22: (a) the step checks, (b) AdaGMN's masked and compacted
    make_train_step in turns, (c) the training CLI's EIMP and batch norm runs
    (`training_cli_path` on EIMP_CLI_RUNS). Returns the kernel launches over
    (a)'s kernel-path steps and (c)'s runs ((b)'s are not counted)."""
    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

    t_phase = time.perf_counter()
    total = eimp_step_checks(dev, AdaGMN, DGNNS, SuperGlue, MatcherConfig, kernels, ka)
    say(f"train eimp (a) {time.perf_counter() - t_phase:.1f} s")
    eimp_step_times(dev, AdaGMN, MatcherConfig, TrainHyperParams, make_train_step, init_opt_state, init_stats)
    say(f"train eimp (a) and (b) {time.perf_counter() - t_phase:.1f} s")
    cli = training_cli_path(dev, kernels, ka, runs=EIMP_CLI_RUNS, resume=False, plain=EIMP_PLAIN,
                            label="train eimp cli")
    say(f"train eimp phase {time.perf_counter() - t_phase:.1f} s")
    return {k: total[k] + cli[k] for k in kernels}


# ---------------------------------------------------------------- phase 23: parallelism
PAR_DIR = "impx_torch/_build/parallel_phase"   # references and the ranks' outputs (gitignored), removed after
PAR_SEED = 23
PAR_ONE_RTOL, PAR_ONE_ATOL = 1e-6, 1e-6         # (a): a sum over one rank changes no value
PAR_LOSS_RTOL, PAR_PARAM_ATOL, PAR_COS_MIN = 1e-5, 2.1e-4, 0.99999   # (b), (c)'s step: tests/test_training.py:113
# one Adam step at lr 1e-4 moves an element by at most lr, so two steps from
# the same start are within 2 lr < PAR_PARAM_ATOL whatever their gradients:
# the step's own gradient (cosines and global norm) is what holds it
PAR_GNORM_RTOL = 1e-4                           # (b), (c): the applied gradient's global norm
PAR_TP_AGREE = {"float32": 0.999, "bfloat16": 0.99}   # (c) indices0 of valid rows against the one-rank path
PAR_PP_AGREE = 0.999                           # (d)
PAR_PP_STAGES, PAR_PP_MICRO = 3, 2
PAR_TIMED = 3                                  # (a): timed steps of each path, in turns
PAR_KERNELS = ("mha_fused", "sinkhorn_fused_stats", "mha_bwd", "attention_key_mass")   # kernels 1, 2, 3, 6
PAR_CHILD_TIMEOUT = 240


def par_model(dev, DGNNS, MatcherConfig, dtype="float32", norm_fn="in", cls=None):
    """The training config's widths (eval_config('spp', 15)) in `dtype`,
    random weights from seed 0; under bn random statistics from PAR_SEED."""
    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype=dtype, norm_fn=norm_fn)
    model = (cls or DGNNS)(cfg, device=dev, seed=0)
    if norm_fn == "bn":
        randomize_batch_norm(model, torch.Generator().manual_seed(PAR_SEED))
    return model


def par_batch(dev):
    """The global training batch, TB pairs of TN keypoints (`train_pairs`), its
    two halves made unequal: pairs TB/2.. lose 300 valid keypoints in image
    0, and pairs 3TB/4.. leave their unmatched image-0 keypoints unsupervised
    (no dustbin entry), so that the loss's global pair counts and the
    global batch-norm moments differ from each half's."""
    data = train_pairs(torch.Generator().manual_seed(PAR_SEED), "cpu")
    half, n = TB // 2, TN
    data["valid0"][half:, n - 300:] = False
    data["matching_mask"][half:, n - 300:n, :] = 0
    data["matching_mask"][3 * TB // 4:, :n, n] = 0
    return {k: v.to(dev) for k, v in data.items()}


def par_step_outputs(model, step, batch):
    """One step of `step` on `batch` (this rank's rows): (its global loss,
    the gradient it applied (each parameter's .grad after it), parameters
    after it), the last two gathered to the single-device layout under
    tensor parallelism."""
    from impx_torch.parallel.tp import gather_full
    from impx_torch.train.step import init_opt_state, init_stats

    metrics, _ = step(init_opt_state(model), 0, batch, init_stats(batch["valid0"].device))
    grads = gather_full(model, {n: torch.zeros_like(p) if p.grad is None else p.grad.detach()
                                for n, p in model.named_parameters()})
    params = gather_full(model, {n: p.detach() for n, p in model.named_parameters()})
    return float(metrics["loss"]), grads, params


def par_compare(label, got, ref, zero, loss_rtol, param_atol, cos_min, gnorm_rtol) -> None:
    """Loss, gradient cosines, the gradient's global norm and parameters of
    par_step_outputs against the one-process step's; zero: the leaves whose
    exact gradient is 0, whose Adam step follows rounding noise (within
    2 lr = 2e-4 of each other)."""
    (loss, grads, params), (rloss, rgrads, rparams) = got, ref
    rel = abs(loss - rloss) / abs(rloss)
    cos = {n: torch.nn.functional.cosine_similarity(grads[n].flatten().double().cpu(),
                                                    rgrads[n].flatten().double().cpu(), dim=0).item()
           for n in rgrads if not zero.search(n) and rgrads[n].abs().max() > 0}
    worst = min(cos, key=cos.get)
    norm = lambda gs: sum(float((g.double() ** 2).sum()) for g in gs.values()) ** 0.5
    gnorm, rgnorm = norm(grads), norm(rgrads)
    gnorm_rel = abs(gnorm - rgnorm) / rgnorm
    diff = {n: (params[n].cpu() - rparams[n].cpu()).abs().max().item() for n in rparams}
    held = {n: d for n, d in diff.items() if not zero.search(n)}
    worst_p = max(held, key=held.get)
    worst_zero = max((d for n, d in diff.items() if zero.search(n)), default=0.0)
    say(f"parallel {label}: loss {loss:.7f} one process {rloss:.7f} relative difference {rel:.3e} (max "
        f"{loss_rtol:g}); of the gradient the step applied: smallest cosine {cos[worst]:.8f} at {worst} (min "
        f"{cos_min}), global norm {gnorm:.6e} one process {rgnorm:.6e} relative difference {gnorm_rel:.3e} (max "
        f"{gnorm_rtol:g}); largest parameter difference {held[worst_p]:.3e} at {worst_p} (max {param_atol:g}); "
        f"over the leaves whose exact gradient is 0 {worst_zero:.3e} (max 2.1e-4)")
    if (rel > loss_rtol or cos[worst] < cos_min or gnorm_rel > gnorm_rtol or held[worst_p] > param_atol
            or worst_zero > 2.1e-4):
        fail(f"parallel {label}: the step disagrees with the one-process step")


def par_world1(dev, kernels, DGNNS, MatcherConfig, TrainHyperParams, make_train_step, init_opt_state,
               init_stats, workdir) -> None:
    """(a): the data-parallel step through a one-rank NCCL group against
    make_train_step's plain step on the same batch and weights, fp32 and
    bf16; their ms a step in turns; a profile of the data-parallel step (its
    NCCL launches, the all-reduces the host issued, their share of the
    device time)."""
    import torch.distributed as dist

    from impx_torch.parallel.mesh import init_distributed, make_mesh, set_data_group

    init_distributed(f"file://{os.path.abspath(workdir)}/rendezvous_nccl", rank=0, world_size=1, device=dev)
    say(f"parallel (a): backend {dist.get_backend()} at world size {dist.get_world_size()}, in process")
    mesh = make_mesh()
    batch = par_batch(dev)
    hp = TrainHyperParams()
    for dtype in ("float32", "bfloat16"):
        plain = par_model(dev, DGNNS, MatcherConfig, dtype)
        dp = set_data_group(par_model(dev, DGNNS, MatcherConfig, dtype), mesh.group())
        one = par_step_outputs(plain, make_train_step(plain, hp), batch)
        got = par_step_outputs(dp, make_train_step(dp, hp), batch)
        par_compare(f"(a) NCCL world 1 {dtype}", got, one, zero_grad_leaves(plain), PAR_ONE_RTOL, PAR_ONE_ATOL,
                    PAR_COS_MIN, PAR_ONE_RTOL)
        del one, got
        steps = {"plain": (plain, make_train_step(plain, hp)), "data-parallel": (dp, make_train_step(dp, hp))}
        opts = {k: (init_opt_state(m), init_stats(dev)) for k, (m, _) in steps.items()}
        times = {k: [] for k in steps}
        for it in range(PAR_TIMED + 1):
            for k, (_, step) in steps.items():
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                step(opts[k][0], it, batch, opts[k][1])
                torch.cuda.synchronize(dev)
                if it:
                    times[k].append(1e3 * (time.perf_counter() - t0))
        calls = collections.Counter()
        all_reduce = dist.all_reduce

        def counted(*a, **kw):
            calls["all_reduce"] += 1
            return all_reduce(*a, **kw)

        dist.all_reduce = counted
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                steps["data-parallel"][1](opts["data-parallel"][0], PAR_TIMED + 1, batch, opts["data-parallel"][1])
                torch.cuda.synchronize(dev)
        finally:
            dist.all_reduce = all_reduce
        busy = device_busy(prof)
        nccl = par_device_events(prof, "nccl")
        nccl_n, nccl_ms = len(nccl), sum(ms for _, ms in nccl)
        nccl = sorted(collections.Counter(name for name, _ in nccl).items())
        n_params = len(list(dp.parameters()))
        say(f"parallel (a) {dtype}: ms a step, plain {statistics.median(times['plain']):.1f} data-parallel "
            f"{statistics.median(times['data-parallel']):.1f} (medians of {PAR_TIMED}, in turns; "
            f"{[round(t, 1) for t in times['data-parallel']]})")
        say(f"parallel (a) {dtype}: the profiled data-parallel step issued {calls['all_reduce']} all-reduces "
            f"(the loss's global counts, and one bucket of the {n_params} parameters' gradients with the loss "
            f"and metrics); NCCL device launches {nccl_n} ({nccl}), {nccl_ms:.3f} ms = "
            f"{nccl_ms / busy[0] if busy else float('nan'):.4f} of the step's {busy[0] if busy else 0:.1f} ms "
            f"of device time")
        if calls["all_reduce"] != 2:
            fail(f"parallel (a): {calls['all_reduce']} all-reduces a step, not the loss counts' and one bucket")
        if nccl_n > calls["all_reduce"]:
            fail(f"parallel (a): {nccl_n} NCCL launches for {calls['all_reduce']} all-reduces")
        del plain, dp, steps, opts
    dist.destroy_process_group()


def par_device_events(prof, needle: str) -> list:
    """(name, ms) of the profiled device operations whose name holds needle."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    events = [] if results is None else results.events()
    return [(e.name(), e.duration_ns() / 1e6) for e in events
            if e.device_type() == DeviceType.CUDA and needle in e.name().lower()]


def par_references(dev, DGNNS, AdaGMN, MatcherConfig, TrainHyperParams, make_train_step, workdir) -> None:
    """The one-process results the ranks hold theirs against, saved under
    workdir: the fp32 step ('in' and 'bn'), IMP's indices0 at fp32 and bf16,
    AdaGMN's (mask-only, fp32) keep counts after every pool, forward_scan's
    indices0 at fp32."""
    from impx_torch.models.fast import forward_scan

    batch = par_batch(dev)
    for norm_fn in ("in", "bn"):
        model = par_model(dev, DGNNS, MatcherConfig, norm_fn=norm_fn)
        torch.save(par_step_outputs(model, make_train_step(model, TrainHyperParams()), batch),
                   f"{workdir}/step_{norm_fn}.pt")
        del model
    data = permuted_pairs(torch.Generator().manual_seed(PAR_SEED), dev)
    refs = {"valid0": data["valid0"].cpu()}
    for dtype in ("float32", "bfloat16"):
        model = par_model(dev, DGNNS, MatcherConfig, dtype)
        with torch.no_grad():
            refs[dtype] = model.produce_matches(data, only_last=True, with_scores=False)["indices0"][-1].cpu()
            if dtype == "float32":
                refs["scan"] = forward_scan(model, data, only_last=True, with_scores=False)["indices0"][-1].cpu()
    eimp = recording_keeps(par_model(dev, DGNNS, MatcherConfig, cls=AdaGMN))
    eimp.bin_score.data.fill_(EIMP_BIN_SCORE)
    with torch.no_grad():
        eimp.produce_matches(overlap_pairs(torch.Generator().manual_seed(PAR_SEED), dev), only_last=True,
                             with_scores=False)
    refs["keeps"] = [(a.cpu(), b.cpu()) for a, b in eimp.keeps]
    torch.save(refs, f"{workdir}/forward.pt")


def par_agree(label, got, want, valid, agree_min) -> None:
    rows = valid.sum().item()
    equal = ((got.cpu() == want) & valid).sum().item()
    frac = equal / rows
    say(f"{label}: indices0 equal on {equal} of {rows} valid rows = {frac:.5f} (min {agree_min}); "
        f"differing rows by pair {((got.cpu() != want) & valid).sum(1).tolist()}")
    if frac < agree_min:
        fail(f"{label}: indices0 agree on {frac:.5f} of valid rows")


def compare_keeps(label, eimp, want) -> None:
    """The keep counts that recording_keeps gathered on `eimp` against one
    process's, after every pool."""
    keeps = [(a.cpu(), b.cpu()) for a, b in eimp.keeps]
    same = len(keeps) == len(want) and all(torch.equal(a, c) and torch.equal(b, d)
                                           for (a, b), (c, d) in zip(keeps, want))
    say(f"{label} AdaGMN mask-only fp32 at dustbin {EIMP_BIN_SCORE}: keep counts after each pool "
        f"{[k[0].tolist() for k in keeps]} (one process {[k[0].tolist() for k in want]}); equal {same}")
    if not same:
        fail(f"{label}: AdaGMN's keep counts differ from one process's")


def par_child_dp_tp(dev, rank, world, workdir, kernels) -> dict:
    """(b), then (c), on one rank of a world of 2 over gloo."""
    from impx_torch.models import DGNNS, MatcherConfig
    from impx_torch.parallel.mesh import make_mesh, set_data_group, shard_batch
    from impx_torch.train.step import TrainHyperParams, make_train_step

    out = {}
    mesh = make_mesh()
    batch = par_batch(dev)
    for norm_fn in ("in", "bn"):
        model = set_data_group(par_model(dev, DGNNS, MatcherConfig, norm_fn=norm_fn), mesh.group())
        t0 = time.perf_counter()
        got = par_step_outputs(model, make_train_step(model, TrainHyperParams()), shard_batch(mesh, batch))
        torch.cuda.synchronize(dev)
        out[f"(b) {norm_fn} ms"] = 1e3 * (time.perf_counter() - t0)
        zero = zero_grad_leaves(model) if norm_fn == "in" else bn_layers_zero_grad_leaves(model)
        par_compare(f"(b) rank {rank} of {world} {norm_fn} fp32, {TB // world} pairs a rank", got,
                    torch.load(f"{workdir}/step_{norm_fn}.pt", weights_only=False), zero, PAR_LOSS_RTOL,
                    PAR_PARAM_ATOL, PAR_COS_MIN, PAR_GNORM_RTOL)
        del model, got
    out.update(par_tp(dev, rank, world, workdir, batch))
    return out


def par_tp(dev, rank, world, workdir, batch) -> dict:
    """(c) on one rank of a (1, 2) grid."""
    import impx_torch.models.gnn as gnn
    from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
    from impx_torch.parallel.mesh import set_data_group
    from impx_torch.parallel.tp import make_2d_mesh, shard_params_tp
    from impx_torch.train.step import TrainHyperParams, make_train_step

    out = {}
    grid = make_2d_mesh(1, world)
    refs = torch.load(f"{workdir}/forward.pt", weights_only=False)
    data = permuted_pairs(torch.Generator().manual_seed(PAR_SEED), dev)
    heads = collections.Counter()
    fused = gnn.mha_fused

    def recording(q, *a, **kw):
        heads[q.shape[1]] += 1
        return fused(q, *a, **kw)

    gnn.mha_fused = recording
    for dtype in ("float32", "bfloat16"):
        model = shard_params_tp(par_model(dev, DGNNS, MatcherConfig, dtype), grid)
        t0 = time.perf_counter()
        with torch.no_grad():
            idx = model.produce_matches(data, only_last=True, with_scores=False)["indices0"][-1]
        torch.cuda.synchronize(dev)
        out[f"(c) IMP {dtype} ms"] = 1e3 * (time.perf_counter() - t0)
        par_agree(f"parallel (c) rank {rank} IMP {dtype} (1, {world})", idx, refs[dtype], refs["valid0"],
                  PAR_TP_AGREE[dtype])
        del model
    gnn.mha_fused = fused
    say(f"parallel (c) rank {rank}: kernel 1 ran at heads {dict(heads)} (of {MatcherConfig().num_heads})")
    if set(heads) != {MatcherConfig().num_heads // world}:
        fail(f"parallel (c): kernel 1 did not run at {MatcherConfig().num_heads // world} heads: {dict(heads)}")

    eimp = recording_keeps(shard_params_tp(par_model(dev, DGNNS, MatcherConfig, cls=AdaGMN), grid))
    eimp.bin_score.data.fill_(EIMP_BIN_SCORE)
    with torch.no_grad():
        eimp.produce_matches(overlap_pairs(torch.Generator().manual_seed(PAR_SEED), dev), only_last=True,
                             with_scores=False)
    compare_keeps(f"parallel (c) rank {rank}", eimp, refs["keeps"])
    del eimp

    model = shard_params_tp(par_model(dev, DGNNS, MatcherConfig), grid)
    set_data_group(model, grid.group("data"))
    got = par_step_outputs(model, make_train_step(model, TrainHyperParams()), batch)
    par_compare(f"(c) rank {rank} tensor-parallel (1, {world}) step fp32", got,
                torch.load(f"{workdir}/step_in.pt", weights_only=False), zero_grad_leaves(model),
                PAR_LOSS_RTOL, PAR_PARAM_ATOL, PAR_COS_MIN, PAR_GNORM_RTOL)
    return out


def par_child_pp(dev, rank, world, workdir, kernels) -> dict:
    """(d) on one stage rank: the GPipe forward at fp32 against forward_scan's."""
    from impx_torch.models import DGNNS, MatcherConfig
    from impx_torch.parallel.pp import make_stage_mesh, pipeline_forward_scan

    refs = torch.load(f"{workdir}/forward.pt", weights_only=False)
    model = par_model(dev, DGNNS, MatcherConfig)
    data = permuted_pairs(torch.Generator().manual_seed(PAR_SEED), dev)
    mesh = make_stage_mesh(world)
    t0 = time.perf_counter()
    idx = pipeline_forward_scan(model, data, mesh, n_microbatches=PAR_PP_MICRO)["indices0"][0]
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    par_agree(f"parallel (d) stage {rank} of {world}, {PAR_PP_MICRO} microbatches, fp32", idx, refs["scan"],
              refs["valid0"], PAR_PP_AGREE)
    return {"(d) ms": ms}


# the ranks share one card, whose time slices between their processes: (b)
# and (c) run in one world (in two worlds side by side the phase took 75.2 s
# against 67.1)
PAR_JOBS = {"dp_tp": par_child_dp_tp, "pp": par_child_pp}
PAR_WORLDS = {"dp_tp": 2, "pp": PAR_PP_STAGES}
PAR_T0 = time.perf_counter()   # a rank's start, for its ms from start


def par_child(job: str, rank: int, world: int, workdir: str, device: str) -> int:
    """A rank of phase 23 (`python3 chip_smoke.py --parallel-rank ...`): every
    rank on the one card, gloo between them. Prints its lines, writes its
    launches, peak memory and ms to workdir; a failed check exits non-zero."""
    from impx_torch.ops.kernels import attention as ka
    from impx_torch.ops.kernels.sinkhorn import sinkhorn_fused_stats
    from impx_torch.parallel.mesh import init_distributed
    import torch.distributed as dist

    dev = torch.device(device)
    init_distributed(f"file://{os.path.abspath(workdir)}/rendezvous_{job}", rank=rank, world_size=world,
                     device=dev, backend="gloo")
    kernels = {"mha_fused": ka.mha_fused, "sinkhorn_fused_stats": sinkhorn_fused_stats, "mha_bwd": ka.mha_bwd,
               "attention_key_mass": ka.attention_key_mass, "mha_fused_lse": ka.mha_fused_lse}
    out = PAR_JOBS[job](dev, rank, world, workdir, kernels)
    out["ms from start"] = 1e3 * (time.perf_counter() - PAR_T0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    summary = {"launches": {k: fn.launches for k, fn in kernels.items()}, "peak_gib": peak, "ms": out}
    with open(f"{workdir}/out_{job}_{rank}.json", "w") as f:
        json.dump(summary, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def par_spawn(job: str, world: int, workdir: str, device: str) -> list:
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", job, str(r), str(world),
                              workdir, device], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def par_collect(job: str, procs: list, workdir: str) -> list:
    """Wait for a world's ranks, print their lines, fail if one failed."""
    outs, failed = [], []
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=PAR_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"parallel {job}: rank {r} did not finish in {PAR_CHILD_TIMEOUT} s")
        for line in text.splitlines():
            say(f"  [{job} rank {r}] {line}")
        if p.returncode:
            failed.append(r)
    if failed:
        fail(f"parallel {job}: ranks {failed} exited non-zero")
    for r in range(len(procs)):
        with open(f"{workdir}/out_{job}_{r}.json") as f:
            outs.append(json.load(f))
    return outs


def parallel_phase(dev, kernels, DGNNS, AdaGMN, MatcherConfig) -> dict:
    """Phase 23: (a) NCCL at world size 1 in process; then, on the one card,
    ranks over gloo (NCCL refuses two ranks on one device; only gloo's
    transport goes through the host): (b) data parallelism at world 2, (c)
    tensor parallelism at (1, 2), in one world of 2, and, alongside, (d) the
    pipeline at 3 stages x 2 microbatches in a world of 3. Returns the launches of
    every kernel over the phase (the ranks' summed)."""
    import shutil

    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

    t_phase = time.perf_counter()
    workdir = PAR_DIR
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    for fn in kernels.values():
        fn.launches = 0
    par_world1(dev, kernels, DGNNS, MatcherConfig, TrainHyperParams, make_train_step, init_opt_state,
               init_stats, workdir)
    launches = {k: fn.launches for k, fn in kernels.items()}
    say(f"parallel (a) {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    par_references(dev, DGNNS, AdaGMN, MatcherConfig, TrainHyperParams, make_train_step, workdir)
    torch.cuda.empty_cache()
    say(f"parallel references {time.perf_counter() - t_phase:.1f} s")
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    worlds = PAR_WORLDS
    procs = {job: par_spawn(job, n, workdir, device) for job, n in worlds.items()}
    say("parallel (b)-(d): ranks sharing the one card over gloo (its transport through the host); "
        "their ms are not a scaling figure")
    for job, ps in procs.items():
        for r, out in enumerate(par_collect(job, ps, workdir)):
            pick = {k: out["launches"].get(k, 0) for k in PAR_KERNELS}
            say(f"parallel {job} rank {r} of {worlds[job]}: launches of kernels 1, 2, 3, 6 {pick}; peak device "
                f"memory {out['peak_gib']:.2f} GiB; ms {({k: round(v, 1) for k, v in out['ms'].items()})} "
                f"(ranks sharing one card)")
            for k, v in out["launches"].items():
                launches[k] = launches.get(k, 0) + v
    missing = [k for k in PAR_KERNELS if not launches.get(k)]
    if missing:
        fail(f"parallel: kernels {missing} never launched in phase 23")
    shutil.rmtree(workdir, ignore_errors=True)
    say(f"parallel phase {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


# ------------------------------------------------------------------ phase 24
SP_DIR = "impx_torch/_build/sp_phase"          # references, the ranks' outputs and the trace (gitignored), removed after
SP_SEED = 24
SP_WORLD = 2                                   # sequence ranks sharing the card over gloo
SP_DTYPES = ("bfloat16",)                      # the eval config's IMP forward (the main path's dtype)
SP_AGREE = {"float32": 0.999, "bfloat16": 0.99}   # indices0 of valid rows against one process
SP_KERNELS = ("mha_fused", "sinkhorn_fused_stats", "mha_bwd", "attention_key_mass", "mha_fused_lse")
# the fp32 kernels' long walks: [4, 4, 2048, 64] and [2, 4, 4096, 64] (its
# last batch fully masked, so one batch of 4096 valid keys)
LONG_F32_SHAPES = ((torch.float32, dict(b=4, n=2048)), (torch.float32, dict(b=2, n=4096)))
FP64_GROWTH_MAX = 1.5                          # a kernel's float64 reading at 4096 keys over its reading at 2048
EXPORT_CPU_LAYERS = 3                          # the CPU-exported artifact: the eval widths, depth cut to 3 layers
HOST_TURNS = 3                                 # host-clock medians of the wrapper, direct launch and op, in turns


def _bwd_fp64(q, k, v, mask, do):
    """o and (dq, dk, dv) of masked attention in float64, the masked keys at
    -1e30 as the kernels take them."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = torch.where(mask[:, None, None, :], q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1e30)
    p = torch.softmax(s, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / q.shape[-1] ** 0.5
    return p @ v, (ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do)


def fp32_against_fp64(dev, ka) -> None:
    """Kernels 1 and 4 (o), 3 and 5 at fp32 at LONG_F32_SHAPES and their
    plain versions, each against float64 (the largest relative L2 over the
    batches with valid keys); kernel 1's o also against its plain version,
    held to FWD_O_REL_L2 a batch, the fully masked one included (kernels 4,
    3 and 5 are held by check_training_kernels at these shapes). Fails if a
    kernel's float64 reading at 4096 keys exceeds FP64_GROWTH_MAX times its
    reading at 2048: an error that grows with the key walk."""
    readings, failures = {}, []
    for dtype, shape in LONG_F32_SHAPES:
        q, k, v, mask, do = training_inputs(torch.Generator().manual_seed(10), dev, dtype, **shape)
        o64, g64 = _bwd_fp64(q, k, v, mask, do)
        o1 = ka.mha_fused(q, k, v, mask)
        o, lse = ka.mha_fused_lse(q, k, v, mask)
        ro, _ = ka.mha_lse_reference(q, k, v, mask)
        rows = [("mha_fused o", o1, ro, o64), ("mha_fused_lse o", o, ro, o64)]
        for name, got, ref in (("mha_bwd", ka.mha_bwd(q, k, v, mask, do), ka.mha_bwd_reference(q, k, v, mask, do)),
                               ("mha_bwd_from_lse", ka.mha_bwd_from_lse(q, k, v, mask, lse, o, do),
                                ka.mha_bwd_from_lse_reference(q, k, v, mask, lse, o, do))):
            rows += [(f"{name} {part}", a, r, x) for part, a, r, x in zip(("dq", "dk", "dv"), got, ref, g64)]
        torch.cuda.synchronize()
        where = f"{list(q.shape)} fp32"
        rel = rel_l2_per_batch(o1, ro)
        limit = FWD_O_REL_L2[dtype]
        say(f"check mha_fused o {where}: relative L2 a batch, largest {rel[:-1].max().item():.3e} over the batches "
            f"with valid keys, fully masked batch {rel[-1].item():.3e} (max {limit:g}); finite "
            f"{bool(torch.isfinite(o1).all())}")
        if not bool(torch.isfinite(o1).all()) or not bool((rel <= limit).all()):
            failures.append(f"mha_fused o at {where} against its plain version")
        for label, kern, plain, exact in rows:
            rk, rp = (rel_l2_per_batch(t.double(), exact)[:-1].max().item() for t in (kern, plain))
            readings.setdefault(label, []).append(rk)
            say(f"fp64 {label} {where}: relative L2 against float64, kernel {rk:.3e}, plain version {rp:.3e}")
        del q, k, v, do, o64, g64, o1, o, lse, ro, rows
        torch.cuda.empty_cache()
    for label, (at_2048, at_4096) in readings.items():
        growth = at_4096 / at_2048
        say(f"fp64 {label}: 4096 keys over 2048 {growth:.3f} (max {FP64_GROWTH_MAX})")
        if not growth <= FP64_GROWTH_MAX:
            failures.append(f"{label} grows with the keys against float64 ({growth:.3f})")
    if failures:
        fail(f"the fp32 kernels at 2048 and 4096 keys: {failures}")


def sp_data(dev):
    """IMP's pairs (permuted, padded) and EIMP's (overlapping), B pairs of N."""
    return (permuted_pairs(torch.Generator().manual_seed(SP_SEED), dev),
            overlap_pairs(torch.Generator().manual_seed(SP_SEED), dev))


def sp_references(dev, DGNNS, AdaGMN, MatcherConfig, TrainHyperParams, make_train_step, workdir) -> None:
    """One process's results, saved under workdir: IMP's indices0 at
    SP_DTYPES, AdaGMN's (mask-only, fp32) keep counts after every pool, and the
    fp32 training step (loss, applied gradient)."""
    imp, eimp_data = sp_data(dev)
    refs = {"valid0": imp["valid0"].cpu()}
    for dtype in SP_DTYPES:
        model = par_model(dev, DGNNS, MatcherConfig, dtype)
        with torch.no_grad():
            refs[dtype] = model.produce_matches(imp, only_last=True, with_scores=False)["indices0"][-1].cpu()
    eimp = recording_keeps(par_model(dev, DGNNS, MatcherConfig, cls=AdaGMN))
    eimp.bin_score.data.fill_(EIMP_BIN_SCORE)
    with torch.no_grad():
        eimp.produce_matches(eimp_data, only_last=True, with_scores=False)
    refs["keeps"] = [(a.cpu(), b.cpu()) for a, b in eimp.keeps]
    model = par_model(dev, DGNNS, MatcherConfig)
    refs["step"] = par_step_outputs(model, make_train_step(model, TrainHyperParams()), par_batch(dev))
    torch.save(refs, f"{workdir}/sp_refs.pt")


def sp_run(dev, DGNNS, AdaGMN, MatcherConfig, mesh, refs, label) -> dict:
    """The sequence-parallel checks on this rank of `mesh` (1, s): IMP's
    forward at SP_DTYPES, AdaGMN mask-only's keep counts, one training step
    at fp32; returns ms of each."""
    from impx_torch.parallel.mesh import set_seq_group
    from impx_torch.parallel.tp import shard_batch_sp
    from impx_torch.train.step import TrainHyperParams, make_train_step

    out = {}
    seq = mesh.group("model")
    imp, eimp_data = sp_data(dev)
    for dtype in SP_DTYPES:
        model = set_seq_group(par_model(dev, DGNNS, MatcherConfig, dtype), seq)
        t0 = time.perf_counter()
        with torch.no_grad():
            idx = model.produce_matches(shard_batch_sp(mesh, imp), only_last=True, with_scores=False)["indices0"][-1]
        torch.cuda.synchronize(dev)
        out[f"IMP {dtype} ms"] = 1e3 * (time.perf_counter() - t0)
        par_agree(f"sequence parallel {label} IMP {dtype}, {N // mesh.size('model')} of {N} keypoints a rank",
                  idx, refs[dtype], refs["valid0"], SP_AGREE[dtype])
        del model
    eimp = recording_keeps(set_seq_group(par_model(dev, DGNNS, MatcherConfig, cls=AdaGMN), seq))
    eimp.bin_score.data.fill_(EIMP_BIN_SCORE)
    with torch.no_grad():
        eimp.produce_matches(shard_batch_sp(mesh, eimp_data), only_last=True, with_scores=False)
    compare_keeps(f"sequence parallel {label}", eimp, refs["keeps"])
    del eimp
    model = set_seq_group(par_model(dev, DGNNS, MatcherConfig), seq)
    t0 = time.perf_counter()
    got = par_step_outputs(model, make_train_step(model, TrainHyperParams()), shard_batch_sp(mesh, par_batch(dev)))
    torch.cuda.synchronize(dev)
    out["step ms"] = 1e3 * (time.perf_counter() - t0)
    par_compare(f"sequence parallel {label} step fp32, {TN // mesh.size('model')} of {TN} keypoints a rank", got,
                refs["step"], zero_grad_leaves(model), PAR_LOSS_RTOL, PAR_PARAM_ATOL, PAR_COS_MIN, PAR_GNORM_RTOL)
    return out


def par_child_sp(dev, rank, world, workdir, kernels) -> dict:
    """Phase 24 (a) on one rank of a (1, world) grid over gloo."""
    from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
    from impx_torch.parallel.tp import make_2d_mesh

    refs = torch.load(f"{workdir}/sp_refs.pt", weights_only=False)
    return sp_run(dev, DGNNS, AdaGMN, MatcherConfig, make_2d_mesh(1, world), refs, f"rank {rank} of (1, {world})")


PAR_JOBS["sp"] = par_child_sp


def sp_world1(dev, DGNNS, AdaGMN, MatcherConfig, workdir) -> None:
    """Phase 24 (a) through a one-rank NCCL group in process (a sequence
    group of one rank: every gather and sum is a copy)."""
    import torch.distributed as dist

    from impx_torch.parallel.mesh import init_distributed
    from impx_torch.parallel.tp import make_2d_mesh

    init_distributed(f"file://{os.path.abspath(workdir)}/rendezvous_sp_nccl", rank=0, world_size=1, device=dev)
    refs = torch.load(f"{workdir}/sp_refs.pt", weights_only=False)
    out = sp_run(dev, DGNNS, AdaGMN, MatcherConfig, make_2d_mesh(1, 1), refs, "NCCL world 1")
    say(f"sequence parallel (a) NCCL world 1 ms {({k: round(v, 1) for k, v in out.items()})}")
    dist.destroy_process_group()


def export_check(label, model, data, fn, want, kernels) -> None:
    """The eager produce_matches and the exported fn on `data`: launches of
    each kernel (against `want`), indices0 and mscores0 bit for bit, and
    ms of each (host clock, synchronised, median of HOST_TURNS in turns)."""
    feed = {k: data[k] for k in ("descriptors0", "descriptors1", "norm_keypoints0", "norm_keypoints1",
                                 "scores0", "scores1", "valid0", "valid1")}
    runs = {"eager": lambda: model.produce_matches(feed, only_last=True, with_scores=False),
            "exported": lambda: fn(feed)}
    outs, launches, times = {}, {}, {k: [] for k in runs}
    for turn in range(HOST_TURNS + 1):
        for name, run in runs.items():
            for f in kernels.values():
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = run()
            torch.cuda.synchronize()
            if turn:
                times[name].append(1e3 * (time.perf_counter() - t0))
            else:
                launches[name] = {k: f.launches for k, f in kernels.items() if f.launches}
                outs[name] = (out["indices0"][-1], out["mscores0"][-1]) if name == "eager" else (
                    out["indices0"], out["mscores0"])
    same = torch.equal(outs["eager"][0], outs["exported"][0]) and torch.equal(outs["eager"][1], outs["exported"][1])
    say(f"export {label}: launches eager {launches['eager']} exported {launches['exported']} (want {want}); "
        f"indices0 and mscores0 bit-equal {same}; ms a call eager {statistics.median(times['eager']):.1f} "
        f"exported {statistics.median(times['exported']):.1f} (medians of {HOST_TURNS}, in turns)")
    for name, run in runs.items():   # where an exported call's time goes: its device operations
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                run()
            torch.cuda.synchronize()
        busy = device_busy(prof)
        say(f"export {label} {name}: device operations a call {busy[1] if busy else 0}, busy "
            f"{busy[0] if busy else 0.0:.3f} ms")
    if launches["eager"] != want or launches["exported"] != want or not same:
        fail(f"export {label}: the exported call differs from the eager one")


def export_phase(dev, DGNNS, AdaGMN, MatcherConfig, kernels) -> None:
    """Phase 24 (b): torch.export on the card at the eval config (bf16) for
    DGNNS and AdaGMN mask-only, through bytes; an artifact exported on the
    CPU (the eval widths at EXPORT_CPU_LAYERS layers) moved to cuda on load."""
    from impx_torch.tools.export import export_matcher, load_matcher

    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 15), compute_dtype="bfloat16")
    imp, eimp_data = sp_data(dev)
    for label, cls, data, want in (
            ("IMP", DGNNS, imp, {"mha_fused": 2 * cfg.n_layers, "sinkhorn_fused_stats": 1}),
            ("EIMP mask-only", AdaGMN, eimp_data, {"mha_fused": 18, "sinkhorn_fused_stats": cfg.n_layers,
                                                   "attention_key_mass": 12, "mha_fused_lse": 12})):
        model = cls(cfg, device=dev, seed=0)
        if cls is AdaGMN:
            model.bin_score.data.fill_(EIMP_BIN_SCORE)
        t0 = time.perf_counter()
        blob = export_matcher(model, n_kpts=N, batch=B)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = load_matcher(blob)
        say(f"export {label} on the card: {len(blob) / 2**20:.1f} MiB, export {t_export:.1f} s, load "
            f"{time.perf_counter() - t0:.1f} s")
        export_check(f"{label} bf16 B={B} N={N}", model, data, fn, want, kernels)
        del model, fn, blob
    small = dataclasses.replace(cfg, n_layers=EXPORT_CPU_LAYERS)
    cpu_model = DGNNS(small, device="cpu", seed=0)
    t0 = time.perf_counter()
    blob = export_matcher(cpu_model, n_kpts=N, batch=B)
    t_export = time.perf_counter() - t0
    card = DGNNS(small, device=dev, seed=0)
    card.load_state_dict(cpu_model.state_dict())
    say(f"export on the CPU ({EXPORT_CPU_LAYERS} layers): {len(blob) / 2**20:.1f} MiB, {t_export:.1f} s; "
        f"moved to cuda on load")
    export_check(f"CPU-exported, moved to cuda, {EXPORT_CPU_LAYERS} layers", card, imp, load_matcher(blob, dev),
                 {"mha_fused": 2 * EXPORT_CPU_LAYERS, "sinkhorn_fused_stats": 1}, kernels)


def custom_op_twin(ka):
    """Kernel 1's launch registered as a torch.library.custom_op (the
    registration the port's ops moved away from), for its dispatch cost."""
    @torch.library.custom_op("impx_smoke::mha_fwd", mutates_args=(), device_types="cuda",
                             schema="(Tensor q, Tensor k, Tensor v, Tensor? key_mask) -> Tensor")
    def twin(q, k, v, key_mask):
        return ka._forward(q, k, v, key_mask, with_lse=False)[0]

    return twin


def host_before_after(dev, ka) -> None:
    """The host microseconds of one kernel-1 call through the wrapper (the
    op `impx::mha_fwd`, a torch.library.Library registration), of the direct
    launch it wrapped before the op registration (`_mha_forward`), and of
    the same launch behind a torch.library.custom_op, in turns on the same
    inputs."""
    att = attention_inputs(torch.Generator().manual_seed(24), dev, torch.bfloat16)
    fns = {"direct launch (before)": ka._mha_forward, "op (after)": ka.mha_fused}
    if dev.type == "cuda":
        fns["custom_op"] = custom_op_twin(ka)
    us = {k: [] for k in fns}
    for _ in range(HOST_TURNS):
        for k, fn in fns.items():
            us[k].append(host_us(fn, att))
    say(f"host mha_fused [8, 4, 2048, 64] bf16, us a call (median of {WRAPPER_CALLS}, {HOST_TURNS} turns): "
        + "; ".join(f"{k} {[round(v, 2) for v in vals]}" for k, vals in us.items()))


def trace_phase(dev, DGNNS, MatcherConfig, workdir) -> None:
    """Phase 24 (c): impx_torch.tools.profiling.trace around one IMP bf16
    call; the Chrome trace must name attn_fwd_wgmma, and its count of that
    kernel's device events against the 30 launches tells whether the
    profiler lost one."""
    from impx_torch.tools.profiling import span, trace

    model = par_model(dev, DGNNS, MatcherConfig, "bfloat16")
    imp, _ = sp_data(dev)
    with torch.no_grad():
        model.produce_matches(imp, only_last=True, with_scores=False)
        with trace(f"{workdir}/trace") as path:
            with span("impx_produce_matches"):
                model.produce_matches(imp, only_last=True, with_scores=False)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    wgmma = [e for e in events if "attn_fwd_wgmma" in str(e.get("name")) and e.get("cat") == "kernel"]
    annotated = any(e.get("name") == "impx_produce_matches" for e in events)
    say(f"trace (c): {os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} events, {len(wgmma)} device events "
        f"of attn_fwd_wgmma (launches {2 * model.config.n_layers}: {2 * model.config.n_layers - len(wgmma)} lost), "
        f"annotated range present {annotated}")
    if not wgmma or not annotated:
        fail("trace (c): the profiler trace does not name attn_fwd_wgmma or the annotated range")


def studies_phase(device: str) -> None:
    """Phase 24 (d): impx's three studies at --fast on the card, each timed."""
    from impx_torch.eval import fm_study, geo_study, pose_study

    for name, study in (("pose_study", pose_study), ("fm_study", fm_study), ("geo_study", geo_study)):
        t0 = time.perf_counter()
        res = study.main(["--fast", "--device", device])
        torch.cuda.synchronize()
        say(f"study {name} --fast on the card: {time.perf_counter() - t0:.1f} s")
        if name == "pose_study":
            worst = min(res[(0.5, 0.2, b)][2] for b in ("torch8", "torch5"))
            if worst < 80.0:
                fail(f"pose_study: the device backends' AUC@20 at 0.5 px, 20% outliers is {worst:.2f} (< 80)")
        elif name == "fm_study":
            inl, sgd = res[(0.5, 0.2, "device")]
            if inl < 95.0 or sgd > 1e-2:
                fail(f"fm_study: the device F at 0.5 px, 20% outliers: GT-inlier {inl:.2f}%, SGD {sgd:.4f}")
        elif not all(np.isfinite(v) for _, r in res for v in r["auc"].values()):
            fail("geo_study: a non-finite AUC")


STUDIES_TIMEOUT = 400


def studies_spawn(device: str):
    """The studies (d) in a process of their own (`--studies <device>`)."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--studies", device],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def studies_collect(proc) -> None:
    try:
        text, _ = proc.communicate(timeout=STUDIES_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"studies (d): not finished in {STUDIES_TIMEOUT} s")
    for line in text.splitlines():
        say(f"  [studies] {line}")
    if proc.returncode:
        fail("studies (d): the studies' process exited non-zero")


def sp_export_phase(dev, kernels, ka, DGNNS, AdaGMN, MatcherConfig) -> dict:
    """Phase 24: kernels 1, 4, 3 and 5 at fp32 with 2048 and 4096 keys (held
    against FWD_O_REL_L2 and TRAIN_REL_L2, read against float64, their error's
    growth with the keys held); (a) sequence parallelism, a one-rank NCCL
    group in process, then 2 ranks over gloo on the one card; while those
    ranks and (d) the studies run in processes of their own, (b) the serving
    export in this one; then, with the card to itself, the host µs of a
    kernel op and (c) a profiler trace. Returns the launches of every kernel
    over the phase (the ranks' summed; the studies' process counts none)."""
    import shutil

    from impx_torch.train.step import TrainHyperParams, make_train_step

    t_phase = time.perf_counter()
    workdir = SP_DIR
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    check_training_kernels(dev, ka, LONG_F32_SHAPES)
    fp32_against_fp64(dev, ka)
    for fn in kernels.values():
        fn.launches = 0
    sp_references(dev, DGNNS, AdaGMN, MatcherConfig, TrainHyperParams, make_train_step, workdir)
    torch.cuda.empty_cache()
    say(f"sequence parallel references {time.perf_counter() - t_phase:.1f} s")
    sp_world1(dev, DGNNS, AdaGMN, MatcherConfig, workdir)
    torch.cuda.empty_cache()
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    ranks, studies = par_spawn("sp", SP_WORLD, workdir, device), studies_spawn(device.split(":")[0])
    say("phase 24: (a)'s 2 ranks and (d)'s studies in processes of their own, (b) here, side by side on the "
        "card: their ms are not a speed figure")
    export_phase(dev, DGNNS, AdaGMN, MatcherConfig, kernels)
    say(f"export (b) {time.perf_counter() - t0:.1f} s")
    launches = {k: fn.launches for k, fn in kernels.items()}
    for r, out in enumerate(par_collect("sp", ranks, workdir)):
        pick = {k: out["launches"].get(k, 0) for k in SP_KERNELS}
        say(f"sequence parallel rank {r} of (1, {SP_WORLD}): launches {pick}; peak device memory "
            f"{out['peak_gib']:.2f} GiB; ms {({k: round(v, 1) for k, v in out['ms'].items()})} (ranks sharing one card)")
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
    say(f"sequence parallel (a) ranks {time.perf_counter() - t0:.1f} s")
    studies_collect(studies)
    say(f"studies (d) {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    for fn in kernels.values():
        fn.launches = 0
    host_before_after(dev, ka)
    t0 = time.perf_counter()
    trace_phase(dev, DGNNS, MatcherConfig, workdir)
    say(f"trace (c) {time.perf_counter() - t0:.1f} s")
    for k, fn in kernels.items():
        launches[k] = launches.get(k, 0) + fn.launches
    missing = [k for k in SP_KERNELS if not launches.get(k)]
    if missing:
        fail(f"phase 24: kernels {missing} never launched")
    shutil.rmtree(workdir, ignore_errors=True)
    say(f"phase 24 {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from impx_torch.models import AdaGMN, DGNNS, MatcherConfig, SuperGlue
    from impx_torch.models.fast import _eimp_do_pool
    from impx_torch.ops.kernels import _build
    from impx_torch.ops.kernels import attention as ka
    from impx_torch.ops.kernels.attention import (
        attention_key_mass, attention_key_mass_reference, mha_fused, mha_reference)
    from impx_torch.ops.kernels.log_sinkhorn import log_sinkhorn_fused_stats, log_sinkhorn_stats_reference
    from impx_torch.ops.kernels.norm import norm_act, norm_act_reference
    from impx_torch.ops.kernels.sinkhorn import (
        plan_dtype, sinkhorn_fused_stats, sinkhorn_stats_reference)
    from impx_torch.tools.convert import load_reference_state_dict, load_superglue_state_dict
    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else f"nvidia-smi failed: {smi.stderr}"
    say(card)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}; "
        f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    seconds, logs = _build.build_seconds()
    say(f"build: {seconds:.1f} s for {sorted(_build.SIGNATURES)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                say(f"  ptxas {name}: {kernel_name(line.split()[-1])}")
            elif "registers" in line or "spill" in line or "error" in line:
                say(f"  ptxas {name}: {line.strip()}")
    forward_resources(logs.get("attention"), _build.load("attention"))
    f32_resources(logs)
    persistent_resources(logs)
    check_sass()

    attention_errs = check_attention(dev, ka)
    errs = {"mha_fused": attention_errs[("mha_fused", torch.bfloat16)],
            "sinkhorn_fused_stats": check_sinkhorn(dev, sinkhorn_fused_stats,
                                                   sinkhorn_stats_reference, plan_dtype)}
    mass_errs = check_mass(dev, attention_key_mass, attention_key_mass_reference, ka.mha_fused_lse)
    errs["attention_key_mass"] = mass_errs[torch.bfloat16]
    norm_errs = check_norm(dev, norm_act, norm_act_reference)
    kernels = {"mha_fused": mha_fused, "sinkhorn_fused_stats": sinkhorn_fused_stats,
               "attention_key_mass": attention_key_mass, "mha_fused_lse": ka.mha_fused_lse,
               "mha_bwd": ka.mha_bwd, "mha_bwd_from_lse": ka.mha_bwd_from_lse,
               "log_sinkhorn_fused_stats": log_sinkhorn_fused_stats}
    GROUP_WRAPPERS.update(zip((g for g, _ in KERNEL_GROUPS[:7]), (
        (mha_fused, ka.mha_fused_lse), (log_sinkhorn_fused_stats,), (ka.mha_bwd,), (ka.mha_bwd_from_lse,),
        (sinkhorn_fused_stats,), (attention_key_mass,), (norm_act,))))
    # the main path and EIMP count the norm kernel's launches too; the later
    # phases hold the attention and Sinkhorn kernels' counts
    matcher_kernels = {**kernels, "norm_act": norm_act}
    model, launches = main_path(dev, DGNNS, MatcherConfig, load_reference_state_dict, matcher_kernels)
    rows = time_all(dev, model, (mha_fused, mha_reference, sinkhorn_fused_stats,
                                 sinkhorn_stats_reference, plan_dtype), errs, launches)
    fp32 = time_fp32_forward(dev, ka, attention_errs)
    profile_main_path(dev, model)
    del model

    models = eimp_models(dev, AdaGMN, MatcherConfig, load_reference_state_dict)
    pool_its = [i for i, pool in enumerate(_eimp_do_pool(models["mask-only"].config)) if pool]
    eimp_launches = eimp_path(dev, models, matcher_kernels, pool_its)
    norm_row = time_norm(dev, norm_act, norm_act_reference, norm_errs, launches["norm_act"],
                         eimp_launches["norm_act"])
    rows.append(time_eimp(dev, models, (attention_key_mass, attention_key_mass_reference, ka.mha_fused_lse),
                          errs["attention_key_mass"], eimp_launches))
    fp32["attention_key_mass"] = time_fp32_mass(dev, attention_key_mass, attention_key_mass_reference,
                                                ka.mha_fused_lse, mass_errs[torch.float32])
    gen = torch.Generator().manual_seed(9)
    pairs = [overlap_pairs(gen, dev) for _ in range(4)]
    for name in ("compacted", "mask-only"):
        groups = profile_calls(f"eimp {name} produce_matches B={B} N={N}",
                               lambda d, m=models[name]: m.produce_matches(d, only_last=True, with_scores=False),
                               pairs)
        if groups is not None:
            ms, n = groups[KERNEL_GROUPS[5][0]]
            say(f"profile eimp {name} attention_key_mass group: {ms:.3f} ms/call over {n:.0f} device launches; "
                f"{MASS_GROUP_MS_BEFORE[name]} ms/call before the one-pass redesign (PERF.md section 5)")
    say(f"peak device memory of the inference phases {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del models

    errs.update(check_training_kernels(dev, ka))
    train_models = training_models(dev, DGNNS, MatcherConfig)
    train_launches = training_step_check(dev, train_models, kernels, ka)
    rows += time_training_kernels(dev, ka, errs, train_launches)
    training_runs(dev, train_models, train_launches, TrainHyperParams, make_train_step,
                  init_opt_state, init_stats)
    del train_models
    f32_models = training_models(dev, DGNNS, MatcherConfig, "float32")
    f32_launches = training_step_check(dev, f32_models, kernels, ka)
    fp32.update(time_fp32_backward(dev, ka, errs, f32_launches))
    training_runs(dev, f32_models, f32_launches, TrainHyperParams, make_train_step, init_opt_state,
                  init_stats, steps=TRAIN_STEPS_F32, fixed_steps=0)
    del f32_models

    log_fns = (log_sinkhorn_fused_stats, log_sinkhorn_stats_reference, plan_dtype)
    errs["log_sinkhorn_fused_stats"] = check_log_sinkhorn(dev, *log_fns)
    log_launches = log_ot_path(dev, DGNNS, MatcherConfig, load_reference_state_dict, kernels)
    superglue_path(dev, SuperGlue, MatcherConfig, load_superglue_state_dict, kernels)
    rows.append(time_log_sinkhorn(dev, *log_fns, errs["log_sinkhorn_fused_stats"],
                                  log_launches["log_sinkhorn_fused_stats"]))
    eval_path(dev, kernels, DGNNS, AdaGMN, MatcherConfig, load_reference_state_dict)
    iterative = iterative_path(dev, kernels, ka, DGNNS, AdaGMN, MatcherConfig, load_reference_state_dict)
    routes = routes_path(dev, kernels, DGNNS, AdaGMN, SuperGlue, MatcherConfig, load_reference_state_dict,
                         load_superglue_state_dict)
    frontend = frontend_path(dev, kernels, DGNNS, MatcherConfig, load_reference_state_dict)
    queue = queue_loops_path(dev, kernels, DGNNS, AdaGMN, MatcherConfig, load_reference_state_dict)
    training_cli = training_cli_phase(dev, kernels, ka, DGNNS, MatcherConfig)
    training_eimp = eimp_training_phase(dev, kernels, ka, AdaGMN, DGNNS, SuperGlue, MatcherConfig)
    parallel = parallel_phase(dev, kernels, DGNNS, AdaGMN, MatcherConfig)
    sp_export = sp_export_phase(dev, kernels, ka, DGNNS, AdaGMN, MatcherConfig)
    for row in rows:
        row["launches_iterative"] = iterative[row["name"]]
        row["launches_routes"] = routes[row["name"]]
        row["launches_frontend"] = frontend[row["name"]]
        row["launches_queue_loops"] = queue[row["name"]]
        row["launches_training_cli"] = training_cli[row["name"]]
        row["launches_training_eimp"] = training_eimp[row["name"]]
        row["launches_parallel"] = parallel.get(row["name"], 0)
        row["launches_sp_export"] = sp_export.get(row["name"], 0)
        if row["name"] in fp32:
            row["fp32"] = fp32[row["name"]]
    rows.append(norm_row)
    say(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(par_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] == ["--studies"]:
        studies_phase(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
