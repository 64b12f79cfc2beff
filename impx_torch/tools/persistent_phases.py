"""Where the time of the persistent Sinkhorn kernels (kernels 2 and 7) goes.

    python -m impx_torch.tools.persistent_phases [--batch 4] [--n 2048] [--iterations 20 100]

Builds csrc/sinkhorn.cu and csrc/log_sinkhorn.cu a second time with
-DIMPX_PHASE_TIMES (csrc/persistent.cuh: thread 0 of CTA 0 adds the card's
global timer between the kernel's phase marks), runs each kernel twice on
dist [batch, n, n] with 0-300 padded keypoints a side, and prints the
microseconds of each phase of the second call as CTA 0 saw them: the build
of the rows, then per iteration the row step, the column partials, the first
grid barrier (with the wait for the slowest CTA), the column reduce and the
second barrier, and the statistics (with their barrier and merge). Needs a
CUDA card and nvcc; the build goes to impx_torch/_build/phases/.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from impx_torch.ops.kernels import _build

PHASES = ("build", "row step", "column partials", "barrier 1", "column reduce", "barrier 2", "stats")
PER_ITERATION = {"row step", "column partials", "barrier 1", "column reduce", "barrier 2"}


def build_timed(names=("sinkhorn", "log_sinkhorn")) -> dict[str, ctypes.CDLL]:
    """Each source compiled with the phase timers, all nvcc processes at once,
    loaded with the wrapper's C signatures."""
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DIMPX_PHASE_TIMES", "-o", str(out_dir / f"lib{n}.so"),
         str(_build.SRC_DIR / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    libs = {}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{n}.so"))
        for fn, argtypes in _build.SIGNATURES[n].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.impx_phase_ns.argtypes = [ctypes.c_void_p]
        lib.impx_phase_ns.restype = ctypes.c_int
        libs[n] = lib
    return libs


def inputs(batch: int, n: int, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    dist = (torch.randn((batch, n, n), generator=gen) * 2).cuda()
    counts = [torch.randint(n - 300, n + 1, (batch,), generator=gen) for _ in range(2)]
    valid = [(torch.arange(n)[None] < c[:, None]).cuda() for c in counts]
    return dist, torch.tensor(0.7, device="cuda"), valid[0], valid[1]


def phases(name: str, lib, args, iterations: int) -> dict[str, float]:
    """Microseconds of each phase of one call (per iteration for the sweep's
    phases), CTA 0's view."""
    from impx_torch.ops.kernels import log_sinkhorn, sinkhorn

    fn = sinkhorn.sinkhorn_fused_stats if name == "sinkhorn" else log_sinkhorn.log_sinkhorn_fused_stats
    saved = _build._loaded.get(name)
    _build._loaded[name] = lib
    buf = (ctypes.c_ulonglong * 8)()
    try:
        for _ in range(2):                    # the first call warms up; read the second
            _build.check(lib.impx_phase_ns(buf), "impx_phase_ns")
            fn(args[0], args[1], iterations, args[2], args[3])
            torch.cuda.synchronize()
        _build.check(lib.impx_phase_ns(buf), "impx_phase_ns")
    finally:
        if saved is None:
            _build._loaded.pop(name, None)
        else:
            _build._loaded[name] = saved
    return {k: buf[i] / 1e3 / (iterations if k in PER_ITERATION else 1) for i, k in enumerate(PHASES)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--n", type=int, default=2048)
    parser.add_argument("--iterations", type=int, nargs="+", default=[20, 100])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("persistent_phases: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    data = inputs(args.batch, args.n)
    for name, lib in build_timed().items():
        for iterations in args.iterations:
            times = phases(name, lib, data, iterations)
            print(f"phases {name} [{args.batch}, {args.n}, {args.n}] {iterations} iterations (us; "
                  f"per iteration for the sweep): " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))


if __name__ == "__main__":
    main()
