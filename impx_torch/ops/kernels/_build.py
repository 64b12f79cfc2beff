"""Build and load the CUDA kernels under impx_torch/csrc/.

Each source is compiled by nvcc for sm_90a into a shared library with a plain
C interface, loaded with ctypes; the sources share device helpers through
csrc/*.cuh (common.cuh, hopper.cuh, persistent.cuh, attention_tf32.cuh). Builds go to impx_torch/_build/ (listed in .gitignore), named by a
hash of the source and the headers, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built on import: the first wrapper
call on a CUDA tensor builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are void*, sizes are int; each
# launching function returns the cudaError_t of its launches
SIGNATURES = {
    "attention": {
        # q, k, v, mask (bool or null), out, batch*heads, heads, nq, nk, dh,
        # is_bf16, stream
        "impx_mha_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # q, k, v, mask, out, lse, batch*heads, heads, nq, nk, dh, is_bf16, stream
        "impx_mha_fwd_lse": [_P] * 6 + [_I] * 6 + [_P],
        # (dh, nk, is_bf16) -> dynamic shared memory of one block, bytes
        "impx_mha_fwd_smem_bytes": [_I, _I, _I],
    },
    "attention_bwd": {
        # q, k, v, mask, dout, scratch, dq, dk, dv, batch*heads, heads, nq, nk,
        # dh, is_bf16, stream
        "impx_mha_bwd": [_P] * 9 + [_I] * 6 + [_P],
        # q, k, v, mask, lse, o, dout, scratch, dq, dk, dv, batch*heads, heads,
        # nq, nk, dh, is_bf16, stream
        "impx_mha_bwd_lse": [_P] * 11 + [_I] * 6 + [_P],
    },
    "attention_mass": {
        # q, k, key_mask, query_mask (bool or null), lse, batch*heads, heads,
        # nq, nk, dh, is_bf16, stream
        "impx_attention_row_lse": [_P] * 5 + [_I] * 6 + [_P],
        # q, k, key_mask, query_mask, lse, partial (null for one split), out,
        # batch*heads, heads, nq, nk, dh, is_bf16, splits, stream
        "impx_attention_key_mass": [_P] * 7 + [_I] * 7 + [_P],
        # batch, heads, nq, nk, is_bf16, SMs -> the default split count
        "impx_attention_key_mass_splits": [_I] * 6,
        # (dh, n, row_lse) -> dynamic shared memory of one fp32 block of the
        # mass at nq = n, or of the standalone row lse at nk = n, bytes
        "impx_attention_mass_f32_smem_bytes": [_I] * 3,
    },
    "log_sinkhorn": {
        # dist, bin, valid0, valid1 (bool or null), overflow rows, u, v, max0,
        # idx0, idx1, workspace, barrier words, batch, n, m, iterations,
        # z_is_bf16, stream
        "impx_log_sinkhorn_stats": [_P] * 12 + [_I] * 5 + [_P],
        # batch, n, m, z_is_bf16, int[8] out -> the persistent schedule
        "impx_log_sinkhorn_schedule": [_I] * 4 + [_P],
    },
    "norm": {
        # x, bias, mask (bool or null), out, images, tokens, channels, slice,
        # cluster, activation, is_bf16, stream
        "impx_norm_act": [_P] * 4 + [_I] * 7 + [_P],
    },
    "sinkhorn": {
        # dist, bin, valid0, valid1 (bool or null), overflow rows, u, v, max0,
        # idx0, idx1, rowmass, colmass, workspace, barrier words, batch, n, m,
        # iterations, plan_is_bf16, stream
        "impx_sinkhorn_stats": [_P] * 14 + [_I] * 5 + [_P],
        # batch, n, m, plan_is_bf16, int[8] out -> the persistent schedule
        "impx_sinkhorn_schedule": [_I] * 4 + [_P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, the shared headers
    and the flags."""
    sources = [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every named source that has no current library, all nvcc
    processes at once. Returns each compiled source's compiler output (ptxas
    register and spill report). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build((name,))
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def build_seconds(names=tuple(SIGNATURES)) -> tuple[float, dict[str, str]]:
    """Build (in parallel) and load every named kernel; (seconds, logs)."""
    t0 = time.perf_counter()
    logs = build(names)
    for name in names:
        load(name)
    return time.perf_counter() - t0, logs
