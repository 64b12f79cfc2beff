"""Where the time of the attention-mass kernel (kernel 6) goes.

    python -m impx_torch.tools.mass_phases [--batch 8] [--heads 4] [--n 2048]

Builds csrc/attention_mass.cu again as variants, each with parts of the bf16
mass kernel (key_mass_bf16) taken out by a text substitution of the source
(each asserted to apply), and times every variant on the lse route at q, k
[batch, heads, n, 64] bf16 with 0-300 padded keys and queries: the device ms
a call over replays of a CUDA graph of 20 calls, in two rounds. The parts:
the producer's loads of each tile's lse and query weights, the exponentials
(p becomes the exponent itself, its FFMA and FADD stay), the TMA copy of each
Q tile, the wgmma products, the second pair of consumer warpgroups (one pair
takes every tile); the skeleton has none of the first four (the ring of
mbarriers, the sums, the wgmma fences and waits), and the last variants take
out the sums, the fences and waits, and every item (the prologue and the
launch alone). A variant's time against the kernel's is what that part
costs where nothing hides it. Needs a CUDA card and nvcc; the builds go to
impx_torch/_build/mass_phases/.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import torch

from impx_torch.ops.kernels import _build

LOADS = [("wv[r] = q < nq && kept(qmask, q);", "wv[r] = true;"),
         ("lv[r] = q < nq ? lse[row + q] : 0.f;", "lv[r] = 0.f;")]
TMA = [("        mbar_expect_tx(&full[st], L::kQBuf);\n"
        "        tma_load_3d(sm + st * L::kQBuf, &tq, &full[st], 0, (i % ntq) * kMassQ, b * heads + i / ntq);\n",
        "        mbar_arrive(&full[st]);\n")]
PRODUCTS = [("wgmma_rs_kmajor_n64(s, ka[kk], dq + 2 * kk, kk)", "(void)0")]
SUMS = [("column_sums(s, lse2 + 64 * group, t4, c, part);", "")]
SYNC = [("    fence_regs(s);\n    fence_regs(ka);\n    wgmma_fence();\n", ""),
        ("    wgmma_commit();\n    fence_regs(s);\n    fence_regs(ka);\n", ""),
        ("wgmma_wait<0>();", "")]
ONE_PAIR = [("constexpr int kMassPairs = 2;", "constexpr int kMassPairs = 1;")]
NO_ITEMS = [("const int i0 = split_begin(items, split, splits), i1 = split_begin(items, split + 1, splits);",
             "const int i0 = 0, i1 = 0;")]


def no_exponentials(src: str) -> str:
    """column_sums adds the exponent instead of its 2^x."""
    start = src.index("__device__ __forceinline__ void column_sums")
    end = src.index("template <int DH>", start)
    body = src[start:end]
    if body.count("ex2(fmaf(") != 4:
        raise ValueError("column_sums in csrc/attention_mass.cu no longer takes four ex2(fmaf(...))")
    return src[:start] + body.replace("ex2(fmaf(", "(fmaf(") + src[end:]


def substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise ValueError(f"no {old!r} in csrc/attention_mass.cu")
        src = src.replace(old, new)
    return src


def variants() -> dict[str, str]:
    src = (_build.SRC_DIR / "attention_mass.cu").read_text()
    skeleton = no_exponentials(substitute(src, LOADS + TMA + PRODUCTS))
    return {
        "kernel": src,
        "no producer loads": substitute(src, LOADS),
        "no exponentials": no_exponentials(src),
        "no Q TMA": substitute(src, TMA),
        "no products": substitute(src, PRODUCTS),
        "no TMA, no products": substitute(src, TMA + PRODUCTS),
        "one pair of warpgroups": substitute(src, ONE_PAIR),
        "skeleton": skeleton,
        "skeleton, no sums": substitute(skeleton, SUMS),
        "skeleton, no wgmma fences and waits": substitute(skeleton, SYNC),
        "skeleton, neither": substitute(skeleton, SUMS + SYNC),
        "prologue alone": substitute(src, NO_ITEMS),
    }


def build_variants() -> dict[str, ctypes.CDLL]:
    """Every variant compiled at once, loaded with the wrapper's C signatures."""
    out_dir = _build.BUILD_DIR / "mass_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(variants().items()):
        path = out_dir / f"variant{i}.cu"
        path.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-o",
             str(out_dir / f"libvariant{i}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out_dir / f"libvariant{i}.so")
    libs = {}
    for name, (proc, lib_path) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in _build.SIGNATURES["attention_mass"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(batch: int, heads: int, n: int, count: int = 4, seed: int = 8):
    """(q, k, key mask, query mask, lse) with 0-300 padded keys and queries,
    lse from kernel 4 on the same q, k and key mask."""
    from impx_torch.ops.kernels.attention import mha_fused_lse

    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(count):
        q, k = (torch.randn((batch, heads, n, 64), generator=gen).cuda().bfloat16() for _ in range(2))
        kmask, qmask = ((torch.arange(n)[None] < torch.randint(max(n - 300, n // 2), n + 1, (batch, 1),
                                                               generator=gen)).cuda() for _ in range(2))
        out.append((q, k, kmask, qmask, mha_fused_lse(q, k, k, kmask)[1]))
    return out


def graph_ms(fn, args, calls: int = 20, runs: int = 12) -> float:
    """Median device ms a call over replays of a CUDA graph of `calls` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in args:
            fn(*x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*args[i % len(args)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def variant_ms(lib, args) -> float:
    """The wrapper's time with `lib` in place of the built kernel library."""
    from impx_torch.ops.kernels.attention import attention_key_mass

    saved = _build._loaded.get("attention_mass")
    _build._loaded["attention_mass"] = lib
    try:
        return graph_ms(attention_key_mass, args)
    finally:
        if saved is None:
            _build._loaded.pop("attention_mass", None)
        else:
            _build._loaded["attention_mass"] = saved


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--n", type=int, default=2048)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mass_phases: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    data = inputs(args.batch, args.heads, args.n)
    libs = build_variants()
    for rnd in range(2):
        for name, lib in libs.items():
            print(f"mass_phases [{args.batch}, {args.heads}, {args.n}, 64] round {rnd} {name}: "
                  f"{1e3 * variant_ms(lib, data):.2f} us a call", flush=True)


if __name__ == "__main__":
    main()
