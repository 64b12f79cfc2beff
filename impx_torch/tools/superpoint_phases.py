"""SuperPoint's encoder layout and conv epilogue, timed side by side on the card.

    python -m impx_torch.tools.superpoint_phases

Three variants of `models/superpoint.py:backbone`, each under
`extract_keypoints` and alone, at bench_suite.py's configurations (480 x 640,
B = 4, K = 1024 at bf16 and fp32; 1200 x 1600, B = 2, K = 2048 at bf16):
  * NCHW, two-pass epilogue: conv, then (y.float() + bias).to(dtype);
  * NCHW, one-pass epilogue: torch.add(y, bias, out=y), the same bits;
  * channels-last, one-pass epilogue (the model's bf16 path; fp32 runs NCHW).
Medians of CUDA-event timed calls over fresh images, the variants in turns
(A B C C B A) within one process, with the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import statistics
import subprocess

import torch
import torch.nn.functional as F

from impx_torch.models import superpoint as sp

CONFIGS = ((480, 640, 4, 1024, torch.bfloat16), (480, 640, 4, 1024, torch.float32),
           (1200, 1600, 2, 2048, torch.bfloat16))
RUNS = 10


def variant(channels_last: bool, one_pass: bool):
    """A backbone with the given encoder layout and conv epilogue."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format

    def conv(params, name, x):
        w = params[f"{name}.weight"].to(x.dtype, memory_format=fmt)
        y = F.conv2d(x, w, padding=w.shape[-1] // 2)
        b = params[f"{name}.bias"].float()[:, None, None]
        return torch.add(y, b, out=y) if one_pass else (y.float() + b).to(x.dtype)

    @torch.no_grad()
    def backbone(params, image, compute_dtype=torch.float32):
        fp32 = compute_dtype == torch.float32
        with sp.ieee_fp32_convs() if fp32 else contextlib.nullcontext():
            x = image.to(compute_dtype).contiguous(memory_format=fmt)
            for block in ("1", "2", "3"):
                for name in (f"conv{block}a", f"conv{block}b"):
                    x = F.relu(conv(params, name, x))
                x = sp._max_pool2(x)
            for name in ("conv4a", "conv4b"):
                x = F.relu(conv(params, name, x))
            scores = conv(params, "convPb", F.relu(conv(params, "convPa", x))).float()
            desc = conv(params, "convDb", F.relu(conv(params, "convDa", x))).float()
        scores = torch.softmax(scores, dim=1)[:, :-1]
        b, _, h, w = scores.shape
        scores = scores.reshape(b, 8, 8, h, w).permute(0, 3, 1, 4, 2).reshape(b, h * 8, w * 8)
        return scores, desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-15)

    return backbone


VARIANTS = {"NCHW, two-pass epilogue": variant(False, False), "NCHW, one-pass epilogue": variant(False, True),
            "channels-last, one-pass epilogue": variant(True, True)}


def cuda_ms(fn, inputs) -> float:
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    times = []
    for i in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("superpoint_phases: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    params = sp.SuperPoint(device="cuda", seed=1).params()
    gen = torch.Generator().manual_seed(0)
    original = sp.backbone
    try:
        for h, w, b, k, dtype in CONFIGS:
            images = [torch.rand((b, 1, h, w), generator=gen).cuda() for _ in range(3)]
            times = {name: [] for name in VARIANTS}
            for name in [*VARIANTS, *reversed(VARIANTS)]:
                sp.backbone = VARIANTS[name]
                full = cuda_ms(lambda x: sp.extract_keypoints(params, x, max_keypoints=k, compute_dtype=dtype), images)
                alone = cuda_ms(lambda x: VARIANTS[name](params, x, dtype), images)
                times[name].append((full, alone))
            for name, t in times.items():
                print(f"{h}x{w} B={b} K={k} {str(dtype)[6:]} {name}: extract_keypoints ms a call "
                      f"{[round(a, 4) for a, _ in t]}, backbone alone {[round(c, 4) for _, c in t]}", flush=True)
    finally:
        sp.backbone = original


if __name__ == "__main__":
    main()
