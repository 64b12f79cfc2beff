"""Where the time and the accuracy of the fp32 attention kernels in 3xTF32 go.

    python -m impx_torch.tools.tf32_phases [--batch 8] [--heads 4] [--n 2048]
        [--only forward|backward] [--accuracy]

Builds csrc/attention.cu and csrc/attention_mass.cu again as variants, each
with csrc/attention_tf32.cuh or the sources changed by a text substitution
(each asserted to apply), and times every variant at q, k, v [batch, heads,
n, 64] fp32 with 0-300 padded keys and queries: kernel 1 (the forward, 20
calls queued back to back: device time) and kernel 6 on the lse route (a
CUDA graph of 20 calls: device time), in two rounds. The variants: the
splits rounded by cvt.rna.tf32.f32 or by the same rounding in integer
arithmetic (the other of the two than the source's); no split (each
operand's fp32 bits as hi, lo = 0); no split pass (the wgmma operands in
shared memory left as they are: what the pass costs where the products in
flight do not hide it); one TF32 pass (hi.hi alone); no P.V (kernel 1's
QK^T and softmax alone); one chain (every tile's P.V chained in O's own
wgmma accumulator, O rescaled first: the design before each tile's products
started from zero and joined O in fp32 registers after the wait). A
variant's time against the kernel's is what that part costs where nothing
hides it. Needs a CUDA card and nvcc; the builds go to
impx_torch/_build/tf32_phases/, and each variant's ptxas registers and
spills of its tf32x3 kernels are printed, with the functions in which
tools/sass_check.py finds a wgmma register fault: a variant so built
computes something else. ptxas builds the forward with one TF32 pass so at
dh 64 from right PTX (Q's fragments overwritten inside the key loop; PERF.md
section 7): its o and times there are not those of one pass.

The backward (csrc/attention_bwd.cu's bwd_*_tf32x3, kernels 3 and 5) is
built again as its own variants and timed at q, k, v, do [32, 4, 1024, 64]
fp32 (the training kernels' shape, BWD_SHAPE) with up to 100 padded keys,
20 calls queued: the kernel;
one TF32 pass (hi.hi alone in all of its products); no split pass (the
tiles' and the own operand's split blocks left as they are; the tiles'
rows still arrive in the raw tile by cp.async); the dq launch
alone; the dk/dv launch alone (reading whatever statistics the scratch
holds); no split and one chain (every tile's dQ, dK and dV products
chained in the running accumulator: the design before, its dV and dK
products serialised).

--accuracy reads instead each variant that computes the same function (the
kernel, one TF32 pass, no split, one chain) against float64 at q, k, v, do
[2, heads, n, 64] for each n of ACCURACY_SIZES (1024, 2048, 4096), keys and
queries alike, up to 100 padded keys: the largest relative L2 error of a
batch of kernel 1's o, of kernel 6's mass (lse route and standalone, a third
of the queries masked) and of kernels 3 and 5's dq, dk and dv (kernel 5 from
the plain version's o and lse), beside the plain versions' readings. A variant
whose error stops growing with n locates where the kernel loses it.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import statistics
import subprocess

import torch

from impx_torch.ops.kernels import _build
from impx_torch.tools.sass_check import library_faults

HEADER = "attention_tf32.cuh"
FILES = (HEADER, "attention.cu", "attention_mass.cu")
CVT = ("  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n  return r;\n",
       "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n")
NO_SPLIT = [(HEADER, "  hi = to_tf32(x);\n  lo = to_tf32(x - __uint_as_float(hi));\n",
             "  hi = __float_as_uint(x);\n  lo = 0u;\n")]
NO_SPLIT_PASS = [(HEADER, "  auto split_tile = [&](int j) {\n", "  auto split_tile = [&](int j) {\n    return;\n"),
                 ("attention_mass.cu", "  auto split_item = [&](int n) {\n",
                  "  auto split_item = [&](int n) {\n    return;\n")]
# the forward's P.V: each 64-key tile's products into an accumulator from
# zero (the kernel), and "one chain": every tile's products in O's own
# accumulator, O rescaled by alpha first (the design before)
PV_TILE = ("        wgmma_tf32_rs(pv, pl[jj], d_hi, jj);\n        wgmma_tf32_rs(pv, ph[jj], d_lo, 1);\n"
           "        wgmma_tf32_rs(pv, ph[jj], d_hi, 1);\n")
ONE_CHAIN = [(HEADER, old, new) for old, new in (
    ("      uint32_t ph[8][4], pl[8][4];\n",
     "#pragma unroll\n      for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n"
     "      uint32_t ph[8][4], pl[8][4];\n"),
    ("      float pv[DH / 2];  // this tile's P V: the accumulator starts from 0 (scale_d = 0)\n"
     "      fence_regs(pv);\n", "      fence_regs(o);\n"),
    (PV_TILE, "        wgmma_tf32_rs(o, pl[jj], d_hi);\n        wgmma_tf32_rs(o, ph[jj], d_lo);\n"
              "        wgmma_tf32_rs(o, ph[jj], d_hi);\n"),
    ("      wgmma_commit();\n      fence_regs(pv);\n", "      wgmma_commit();\n      fence_regs(o);\n"),
    ("      wgmma_wait<0>();\n      fence_regs(pv);\n#pragma unroll\n"
     "      for (int i = 0; i < DH / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);\n",
     "      wgmma_wait<0>();\n      fence_regs(o);\n"))]
ONE_PASS = [
    (HEADER, "      wgmma_tf32_rs_n64(s, ql[kk], d_hi, kk);\n      wgmma_tf32_rs_n64(s, qh[kk], d_lo, 1);\n"
             "      wgmma_tf32_rs_n64(s, qh[kk], d_hi, 1);\n", "      wgmma_tf32_rs_n64(s, qh[kk], d_hi, kk);\n"),
    (HEADER, PV_TILE, "        wgmma_tf32_rs(pv, ph[jj], d_hi, jj);\n"),
    ("attention_mass.cu", "      wgmma_tf32_rs_n64(s, kl[kk], d_hi, kk);\n      wgmma_tf32_rs_n64(s, kh[kk], d_lo, 1);\n"
                          "      wgmma_tf32_rs_n64(s, kh[kk], d_hi, 1);\n",
     "      wgmma_tf32_rs_n64(s, kh[kk], d_hi, kk);\n")]
NO_PV = [(HEADER, PV_TILE, "")]

BWD = "attention_bwd.cu"
BWD_SHAPE = (32, 4, 1024, 64)
BWD_PART = ("    wgmma_tf32_rs(part, al[jj], b_hi, jj);\n    wgmma_tf32_rs(part, ah[jj], b_lo, 1);\n"
            "    wgmma_tf32_rs(part, ah[jj], b_hi, 1);\n")
BWD_ONE_PASS = [
    (BWD, "    wgmma_tf32_rs_n32(s, x1l[kk], b_hi, kk);\n    wgmma_tf32_rs_n32(s, x1h[kk], b_lo, 1);\n"
          "    wgmma_tf32_rs_n32(s, x1h[kk], b_hi, 1);\n", "    wgmma_tf32_rs_n32(s, x1h[kk], b_hi, kk);\n"),
    (BWD, "    wgmma_tf32_ss_n32(p2, a_lo, b_hi, kk);\n    wgmma_tf32_ss_n32(p2, a_hi, b_lo, 1);\n"
          "    wgmma_tf32_ss_n32(p2, a_hi, b_hi, 1);\n", "    wgmma_tf32_ss_n32(p2, a_hi, b_hi, kk);\n"),
    (BWD, BWD_PART, "    wgmma_tf32_rs(part, ah[jj], b_hi, jj);\n")]
BWD_NO_SPLIT = [(BWD, "#include \"attention_tf32.cuh\"\n",
                 "#include \"attention_tf32.cuh\"\n#define split_tf32 split_tf32_none\n"
                 "__device__ __forceinline__ void split_tf32_none(float x, uint32_t& hi, uint32_t& lo) {\n"
                 "  hi = __float_as_uint(x);\n  lo = 0u;\n}\n")]
BWD_NO_SPLIT_PASS = [
    (BWD, "  constexpr int kItems = kTfRows * DH / 4;\n", "  return;\n  constexpr int kItems = kTfRows * DH / 4;\n"),
    (BWD, "  constexpr int kItems = kTfTile * DH / 4;\n", "  return;\n  constexpr int kItems = kTfTile * DH / 4;\n"),
    (BWD, "  constexpr int kItems = kTfTile / 8 * 2 * DH;\n", "  return;\n  constexpr int kItems = kTfTile / 8 * 2 * DH;\n")]
BWD_DQ_ALONE = [(BWD, "  err = cudaGetLastError();\n  if (err != cudaSuccess) return err;\n  dkdv_kernel<<<",
                 "  return cudaGetLastError();\n  dkdv_kernel<<<")]
BWD_DKDV_ALONE = [(BWD, "  dq_kernel<<<dim3((a.nq + kTfRows", "  if (false) dq_kernel<<<dim3((a.nq + kTfRows")]
# "one chain": the backward's tile products (add_tile_product) chained in the
# running accumulator instead of taken from zero
BWD_CHAIN = [(BWD, BWD_PART, BWD_PART.replace("part, ", "acc, ").replace("jj);", "1);")),
             (BWD, "#pragma unroll\n  for (int i = 0; i < DH / 2; ++i) acc[i] += part[i];\n", ""),
             (BWD, "fence_regs(part);", "fence_regs(acc);")]

ACCURACY_VARIANTS = ("kernel", "one TF32 pass", "no split", "one chain")
ACCURACY_SIZES = (1024, 2048, 4096)


def substitute(srcs: dict[str, str], triples) -> dict[str, str]:
    srcs = dict(srcs)
    for name, old, new in triples:
        if old not in srcs[name]:
            raise ValueError(f"no {old!r} in csrc/{name}")
        srcs[name] = srcs[name].replace(old, new)
    return srcs


def variants() -> dict[str, dict[str, str]]:
    """Each variant's sources. The other rounding is the one the header does
    not use."""
    srcs = {name: (_build.SRC_DIR / name).read_text() for name in FILES}
    cvt, integer = CVT
    uses_cvt = cvt in srcs[HEADER]
    other = [(HEADER, cvt, integer) if uses_cvt else (HEADER, integer, cvt)]
    return {
        "kernel": srcs,
        "split by integer rounding" if uses_cvt else "split by cvt.rna": substitute(srcs, other),
        "no split": substitute(srcs, NO_SPLIT),
        "no split pass": substitute(srcs, NO_SPLIT_PASS),
        "one TF32 pass": substitute(srcs, ONE_PASS),
        "no P.V": substitute(srcs, NO_PV),
        "one chain": substitute(srcs, ONE_CHAIN),
    }


def bwd_variants() -> dict[str, dict[str, str]]:
    """Each backward variant's source."""
    srcs = {BWD: (_build.SRC_DIR / BWD).read_text()}
    return {"kernel": srcs, "one TF32 pass": substitute(srcs, BWD_ONE_PASS),
            "no split": substitute(srcs, BWD_NO_SPLIT),
            "no split pass": substitute(srcs, BWD_NO_SPLIT_PASS),
            "dq launch alone": substitute(srcs, BWD_DQ_ALONE),
            "dk/dv launch alone": substitute(srcs, BWD_DKDV_ALONE),
            "one chain": substitute(srcs, BWD_CHAIN)}


def tf32_resources(log: str) -> list[str]:
    """ptxas's registers and spills of each tf32x3 kernel in a build log."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = line.split()[-1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel and "tf32x3" in kernel:
            name = re.search(r"((?:attn_fwd|key_mass|bwd_[a-z]+_[a-z]+)_tf32x3)I((?:L[a-z]\d+E)+)E", kernel)
            label = (f"{name.group(1)}<{', '.join(re.findall(r'L[a-z](\d+)E', name.group(2)))}>" if name
                     else kernel)
            out.append(f"{label}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def build_variants(which=variants, tag: str = "variant", names=("attention", "attention_mass"),
                   keep=None) -> dict[str, dict[str, ctypes.CDLL]]:
    """Every variant's libraries (csrc/<name>.cu for each of `names`)
    compiled at once, loaded with the wrappers' C signatures; each one's
    tf32x3 registers and spills printed. keep: the variants to build (all
    when None)."""
    out_dir = _build.BUILD_DIR / "tf32_phases"
    procs = {}
    for i, (name, srcs) in enumerate(which().items()):
        if keep is not None and name not in keep:
            continue
        vdir = out_dir / f"{tag}{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for file, text in srcs.items():   # the header is found before csrc/'s: it sits beside the sources
            (vdir / file).write_text(text)
        for lib in names:
            procs[(name, lib)] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-o",
                 str(vdir / f"lib{lib}.so"), str(vdir / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), vdir / f"lib{lib}.so")
    libs: dict[str, dict[str, ctypes.CDLL]] = {}
    for (name, lib), (proc, path) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{log}")
        for line in tf32_resources(log):
            print(f"tf32_phases ptxas {name} {line}", flush=True)
        faulty = sorted(fn for fn, found in library_faults(path).items() if found)
        print(f"tf32_phases sass {name} {lib}: wgmma register faults in {faulty or 'no function'}", flush=True)
        handle = ctypes.CDLL(str(path))
        for fn, argtypes in _build.SIGNATURES[lib].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[lib] = handle
    return libs


def inputs(batch: int, heads: int, n: int, count: int = 4, seed: int = 8):
    """(q, k, v, key mask, query mask) fp32 with 0-300 padded keys and queries."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(count):
        q, k, v = (torch.randn((batch, heads, n, 64), generator=gen).cuda() for _ in range(3))
        kmask, qmask = ((torch.arange(n)[None] < torch.randint(max(n - 300, n // 2), n + 1, (batch, 1),
                                                               generator=gen)).cuda() for _ in range(2))
        out.append((q, k, v, kmask, qmask))
    return out


def queued_ms(fn, args, calls: int = 20, runs: int = 12) -> float:
    """Median device ms a call over windows of `calls` calls queued back to back."""
    for x in args:
        fn(*x)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(*args[i % len(args)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


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


@contextlib.contextmanager
def using(libs: dict[str, ctypes.CDLL]):
    """The wrappers launch from `libs` ({source name: library}) inside the block."""
    saved = {lib: _build._loaded.get(lib) for lib in libs}
    _build._loaded.update(libs)
    try:
        yield
    finally:
        for lib, handle in saved.items():
            if handle is None:
                _build._loaded.pop(lib, None)
            else:
                _build._loaded[lib] = handle


def variant_ms(libs: dict[str, ctypes.CDLL], data) -> tuple[float, float]:
    """(kernel 1 queued ms, kernel 6 lse-route graph ms) with `libs` in place
    of the built kernel libraries."""
    from impx_torch.ops.kernels.attention import attention_key_mass, mha_fused, mha_fused_lse

    with using(libs):
        fwd = queued_ms(mha_fused, [x[:4] for x in data])
        mass_args = [(q, k, km, qm, mha_fused_lse(q, k, k, km)[1]) for q, k, _, km, qm in data]
        return fwd, graph_ms(attention_key_mass, mass_args)


def bwd_inputs(count: int = 3, seed: int = 11):
    """(q, k, v, key mask, do) fp32 at BWD_SHAPE with up to 100 padded keys,
    the last batch's keys all masked (chip_smoke.py's training inputs)."""
    batch, _, n, _ = BWD_SHAPE
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(count):
        q, k, v, do = (torch.randn(BWD_SHAPE, generator=gen).cuda() for _ in range(4))
        mask = torch.arange(n)[None] < torch.randint(max(n - 100, 2 * n // 3), n + 1, (batch, 1), generator=gen)
        mask[-1] = False
        out.append((q, k, v, mask.cuda(), do))
    return out


def bwd_variant_ms(lib: ctypes.CDLL, data) -> tuple[float, float]:
    """(kernel 3, kernel 5) queued ms a call with `lib` in place of the built
    backward library."""
    from impx_torch.ops.kernels.attention import mha_bwd, mha_bwd_from_lse, mha_fused_lse

    with_lse = []
    for q, k, v, m, do in data:
        o, lse = mha_fused_lse(q, k, v, m)
        with_lse.append((q, k, v, m, lse, o, do))
    with using({"attention_bwd": lib}):
        return queued_ms(mha_bwd, data), queued_ms(mha_bwd_from_lse, with_lse)


# ---------------------------------------------------------------- accuracy
def accuracy_inputs(heads: int, n: int, seed: int = 12):
    """q, k, v, do [2, heads, n, 64] fp32, a key mask with up to 100 padded
    keys and a query mask with a third of the queries masked."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((2, heads, n, 64), generator=gen).cuda() for _ in range(4))
    kmask = torch.arange(n)[None] < torch.randint(n - 100, n + 1, (2, 1), generator=gen)
    qmask = torch.rand((2, n), generator=gen) > 1 / 3
    return q, k, v, do, kmask.cuda(), qmask.cuda()


def exact(q, k, v, do, kmask, qmask):
    """float64 o, (dq, dk, dv) and the key mass of masked attention."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = torch.where(kmask[:, None, None, :], q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1e30)
    p = torch.softmax(s, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / q.shape[-1] ** 0.5
    mass = torch.einsum("bhqk,bq->bk", p, qmask.double())
    return p @ v, (ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do), mass


def rel_l2(a, ref) -> float:
    """The largest ||a_b - ref_b|| / ||ref_b|| over the batches b."""
    a, ref = a.double().flatten(1), ref.double().flatten(1)
    return ((a - ref).norm(dim=1) / ref.norm(dim=1)).max().item()


def forward_errors(data, ref) -> dict[str, float]:
    """Kernel 1's o and kernel 6's mass on both routes against float64."""
    from impx_torch.ops.kernels.attention import attention_key_mass, mha_fused, mha_fused_lse

    q, k, v, _, kmask, qmask = data
    o64, _, mass64 = ref
    lse = mha_fused_lse(q, k, k, kmask)[1]
    return {"kernel 1 o": rel_l2(mha_fused(q, k, v, kmask), o64),
            "kernel 6 lse route": rel_l2(attention_key_mass(q, k, kmask, qmask, lse), mass64),
            "kernel 6 standalone": rel_l2(attention_key_mass(q, k, kmask, qmask), mass64)}


def backward_errors(data, ref, o, lse) -> dict[str, float]:
    """Kernels 3 and 5's dq, dk and dv against float64 (kernel 5 from o and lse)."""
    from impx_torch.ops.kernels.attention import mha_bwd, mha_bwd_from_lse

    q, k, v, do, kmask, _ = data
    out = {}
    for name, got in (("kernel 3", mha_bwd(q, k, v, kmask, do)),
                      ("kernel 5", mha_bwd_from_lse(q, k, v, kmask, lse, o, do))):
        out.update({f"{name} {part}": rel_l2(a, r) for part, a, r in zip(("dq", "dk", "dv"), got, ref[1])})
    return out


def plain_errors(data, ref) -> dict[str, float]:
    """The plain fp32 versions' readings against float64."""
    from impx_torch.ops.kernels import attention as ka

    q, k, v, do, kmask, qmask = data
    o, lse = ka.mha_lse_reference(q, k, v, kmask)
    out = {"kernel 1 o": rel_l2(o, ref[0]),
           "kernel 6": rel_l2(ka.attention_key_mass_reference(q, k, kmask, qmask), ref[2])}
    for name, got in (("kernel 3", ka.mha_bwd_reference(q, k, v, kmask, do)),
                      ("kernel 5", ka.mha_bwd_from_lse_reference(q, k, v, kmask, lse, o, do))):
        out.update({f"{name} {part}": rel_l2(a, r) for part, a, r in zip(("dq", "dk", "dv"), got, ref[1])})
    return out


def accuracy(heads: int, only: str | None) -> None:
    """Each variant that computes the same function against float64 at each size."""
    from impx_torch.ops.kernels import attention as ka

    fwd = {} if only == "backward" else build_variants(keep=ACCURACY_VARIANTS)
    bwd = {} if only == "forward" else build_variants(bwd_variants, "bwd", ("attention_bwd",),
                                                      keep=ACCURACY_VARIANTS)
    for n in ACCURACY_SIZES:
        data = accuracy_inputs(heads, n)
        ref = exact(*data)
        where = f"[2, {heads}, {n}, 64]"
        for label, err in plain_errors(data, ref).items():
            print(f"tf32_phases accuracy {where} plain version {label}: relative L2 against float64 {err:.3e}",
                  flush=True)
        o, lse = ka.mha_lse_reference(*data[:3], data[4])
        for kind, libs in (("forward", fwd), ("backward", bwd)):
            for name, lib in libs.items():
                with using(lib):
                    errs = forward_errors(data, ref) if kind == "forward" else backward_errors(data, ref, o, lse)
                for label, err in errs.items():
                    print(f"tf32_phases accuracy {where} {name} {label}: relative L2 against float64 {err:.3e}",
                          flush=True)
        del data, ref, o, lse


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--n", type=int, default=2048)
    parser.add_argument("--only", choices=("forward", "backward"), default=None)
    parser.add_argument("--accuracy", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tf32_phases: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    if args.accuracy:
        accuracy(args.heads, args.only)
        return
    if args.only != "backward":
        data = inputs(args.batch, args.heads, args.n)
        libs = build_variants()
        for rnd in range(2):
            for name, lib in libs.items():
                fwd, mass = variant_ms(lib, data)
                print(f"tf32_phases [{args.batch}, {args.heads}, {args.n}, 64] round {rnd} {name}: kernel 1 "
                      f"{fwd:.4f} ms a call (queued), kernel 6 lse route {mass:.4f} ms a call (graph)", flush=True)
        del data
    if args.only != "forward":
        data = bwd_inputs()
        libs = build_variants(bwd_variants, "bwd", ("attention_bwd",))
        for rnd in range(2):
            for name, lib in libs.items():
                k3, k5 = bwd_variant_ms(lib["attention_bwd"], data)
                print(f"tf32_phases backward {list(BWD_SHAPE)} round {rnd} {name}: "
                      f"kernel 3 {k3:.4f} ms a call, kernel 5 {k5:.4f} (queued)", flush=True)


if __name__ == "__main__":
    main()
