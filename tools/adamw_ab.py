#!/usr/bin/env python3
"""Where the time of the fused AdamW update goes, on one CUDA card: each
variant is `src/repro_torch/csrc/adamw.cu` with one edit (or another
version of the file), built into its own library and timed at the leaf
shapes of chip_smoke.py phase 19 beside a copy kernel that moves exactly
the int8 path's bytes in its access pattern.

    python3 tools/adamw_ab.py [--ref FILE] [variant ...]

Variants (all by default, base first): `base`, the checkout's source;
`ref`, FILE (an earlier adamw.cu, e.g. `git show REV:src/repro_torch/
csrc/adamw.cu > build/adamw_ref.cu`; only with --ref); and one-edit
decompositions of the int8 path: `ieee-div` (the corrected multiplies
back to __fdiv_rn: what they save), `no-check` (the update's numerator
check dropped: exact here only because no numerator is out of range),
`mul-div` (a plain multiply by the reciprocal: inexact, the divisions'
floor), `no-bias` (the codes' rint and float <-> int conversions back
to rintf and casts instead of the 1.5 * 2^23 bias: what the bias
saves), `minb4` (4 thread blocks an SM asked of ptxas, and a grid of 4
an SM), `prefetch` (the next pair's bytes fetched into L2 ahead),
`one-pair` (the source as it is, launched with a block for every 8
pairs: one pair a warp), `roots` (the v code by its two roots instead of
the threshold count), `roots-floor` (the roots of max(frac, 2^-40): the
same codes, no zero or subnormal root), `vh-guard` (the update's root of
a zero vh skipped). The case SPARSE has g, m and v zero on all rows but
1 in 300, as the token embedding's leaf has in a training step.

    python3 tools/adamw_ab.py --step [variant ...]

also times each variant inside the qwen int8 training step
(tools/train_step_profile.py's `qwen-int8`: eager and replayed, wall and
profiler device time), in a process of its own a variant, in the order
given and then reversed.

The copy kernel reads and writes the int8 path's bytes as the kernel
does (one warp a (row, block) pair, 8 consecutive elements a lane, every
load before any store; a warp walks its pairs, grid-stride), timed at 3
(the kernel's grid) and 8 thread blocks of 8 warps an SM and at one
pair a warp; its least time is the floor of that access pattern.

Per variant it prints ptxas's registers and spills for the int8 kernel
and the blocks an SM holds at those registers (8-warp blocks, 64 warps
and 64K registers an SM, allocation in 256-register units a warp);
per case the median of chip_smoke.Timing (5 CUDA-event windows over graph
replays) beside the bound (roofline.kernels), whether m, v, the codes,
scales and EF bytes equal the plain version's and p the base kernel's;
then the qwen int8 step's leaves (chip_smoke's 4-layer qwen2-7b, 51
leaves): each distinct shape's time times its count, summed against the
summed bound and the copy kernel's summed least time. Prints the card's name and power limit.
"""
from __future__ import annotations

import math
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SRC = "adamw.cu"
FAST = """  const float q0 = __fmaf_rn(a, d.y, __fmul_rn(a, d.ylo));
  const float r = __fmaf_rn(-d.b, q0, a);
  return __fmaf_rn(r, d.y, q0);"""
IN_RANGE = "  return (x <= d.hi) & ((x >= d.lo) | (__float_as_uint(a) == 0u));"
# the codes' rint and conversions as rintf and casts: a held k is k itself
NO_BIAS = [
    ("constexpr float kHeld0 = kRound;", "constexpr float kHeld0 = 0.0f;"),
    ("  return clamp_to(__fadd_rn(x, kRound), kHeld0 + lo, kHeld0 + hi);",
     "  return clamp_to(rintf(x), lo, hi);"),
    ("  return __float_as_uint(t);", "  return (uint32_t)(int)t;"),
    ("  return __fsub_rn(__uint_as_float(kBias | b), kRound + off);",
     "  return __fsub_rn((float)b, off);")]
MIN_BLOCKS = "constexpr int kMinBlocks = 3;"
# the v code by its two roots instead of the threshold count (`roots`),
# and with a frac under 2^-40 (code 0 either way) raised to 2^-40, which
# keeps zeros and subnormals off the roots' slow path (`roots-floor`)
V_CODE = "    vw[k >> 2] |= v_code(frac, vbase, vthr) << sh;"
ROOTS = ("    vw[k >> 2] |= (held_bits(held_code(__fmul_rn(__fsqrt_rn("
         "__fsqrt_rn(frac)), 255.0f), 0.0f, 255.0f)) & 0xffu) << sh;")
ROOTS_FLOOR = ROOTS.replace("(frac)", "(fmaxf(frac, 0x1p-40f))")
# the update's root of a zero vh skipped (the same den)
VH_ROOT = "  const float den = __fadd_rn(__fsqrt_rn(vh), h.eps);"
VH_GUARD = """  const float root = vh == 0.0f ? vh : __fsqrt_rn(vh == 0.0f ? 1.0f : vh);
  const float den = __fadd_rn(root, h.eps);"""
ROW = "    float* const prow = p + r * d + col;\n"
# the next pair's p, g, codes and EF bytes fetched into L2 ahead
PREFETCH = ROW + """    if (blk + (long long)gridDim.x * WARPS < total) {
      const long long nx = blk + (long long)gridDim.x * WARPS;
      const long long nr = nx / nb, nc = (nx - nr * nb) * BLOCK
                                         + lane * PER_LANE;
      const long long ncode = nr * dpad + nc;
      asm volatile("prefetch.global.L2 [%0];" :: "l"(p + nr * d + nc));
      asm volatile("prefetch.global.L2 [%0];" :: "l"(g + nr * d + nc));
      asm volatile("prefetch.global.L2 [%0];" :: "l"(mq + ncode));
      asm volatile("prefetch.global.L2 [%0];" :: "l"(vq + ncode));
      asm volatile("prefetch.global.L2 [%0];" :: "l"(mef + ncode / 4));
    }
"""
# name: source edits [(old, new)]
VARIANTS = {
    "base": [],
    "ieee-div": [(FAST, "  return __fdiv_rn(a, d.b);")],
    "no-check": [(IN_RANGE, "  return true;")],
    "mul-div": [(FAST, "  return __fmul_rn(a, d.y);")],
    "no-bias": NO_BIAS,
    "minb4": [(MIN_BLOCKS, MIN_BLOCKS.replace("3", "4"))],
    "prefetch": [(ROW, PREFETCH)],
    "one-pair": [],
    "roots": [(V_CODE, ROOTS)],
    "roots-floor": [(V_CODE, ROOTS_FLOOR)],
    "vh-guard": [(VH_ROOT, VH_GUARD)],
}
# thread blocks an SM of a variant's grid where it is not
# adamw.Q8_BLOCKS_PER_SM (one-pair: a block for every 8 pairs)
BLOCKS_PER_SM = {"minb4": 4, "one-pair": 1 << 40}
INEXACT = ("mul-div",)
OUT = ROOT / "build" / "ab_adamw"
LR = 3e-3
ITERS = 10
# a leaf whose rows take a gradient 1 in SPARSE_EVERY (g, m and v 0 on
# the others): the token embedding's, whose rows a step's 512 tokens touch
SPARSE = "w_down's shape, 1 row in 300 with a gradient (the embedding's)"
SPARSE_EVERY = 300
# (label, leaf shape, moments): chip_smoke's ADAMW_CASES rows that the
# kernel table quotes, and hymba's rows without the ragged block
CASES = (("qwen w_down", (18944, 3584), "float32"),
         ("qwen w_down", (18944, 3584), "int8"),
         ("hymba w_down", (5504, 1600), "float32"),
         ("hymba w_down", (5504, 1600), "int8"),
         ("hymba w_down, d 1792 (no ragged block)", (5504, 1792), "int8"),
         (SPARSE, (18944, 3584), "int8"))
STEP = ("qwen2-7b", 4)        # chip_smoke phase 19(c)/(f)'s model

COPY_CU = r"""
// The int8 path's bytes and nothing else, in adamw_q8_kernel's order: a
// warp a (row, block) pair at a time, walking its pairs grid-stride; a
// lane loads its 8 consecutive p and g (float4 where whole and aligned),
// its 8 m and v code bytes, its EF pair and the block's two scales, then
// stores p, the codes, the EF pair and (lane 0) the scales.
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256)
copy_q8(float* __restrict__ p, const float* __restrict__ g,
        int8_t* __restrict__ mq, float* __restrict__ ms,
        uint8_t* __restrict__ mef, uint8_t* __restrict__ vq,
        float* __restrict__ vs, long long rows, long long d, long long nb) {
  const int lane = threadIdx.x & 31;
  const long long total = rows * nb;
  for (long long blk = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
       blk < total; blk += (long long)gridDim.x * 8) {
    const long long r = total <= 0xffffffffLL
                            ? (long long)((unsigned)blk / (unsigned)nb)
                            : blk / nb;
    const long long col = (blk - r * nb) * 256 + lane * 8;
    const long long code = r * nb * 256 + col;
    float* pr = p + r * d + col;
    const float* gr = g + r * d + col;
    const bool whole = col + 8 <= d &&
                       (reinterpret_cast<uintptr_t>(pr) & 15) == 0;
    float4 a[2] = {}, c[2] = {};
    if (whole) {
      a[0] = reinterpret_cast<const float4*>(pr)[0];
      a[1] = reinterpret_cast<const float4*>(pr)[1];
      c[0] = reinterpret_cast<const float4*>(gr)[0];
      c[1] = reinterpret_cast<const float4*>(gr)[1];
    } else {
      float* af = reinterpret_cast<float*>(a);
      float* cf = reinterpret_cast<float*>(c);
      for (int k = 0; k < 8; ++k)
        if (col + k < d) { af[k] = pr[k]; cf[k] = gr[k]; }
    }
    uint2 m = *reinterpret_cast<const uint2*>(mq + code);
    uint2 v = *reinterpret_cast<const uint2*>(vq + code);
    uint16_t e = *reinterpret_cast<const uint16_t*>(mef + code / 4);
    const float sm = ms[blk], sv = vs[blk];
    for (int k = 0; k < 2; ++k) {
      a[k].x += c[k].x; a[k].y += c[k].y; a[k].z += c[k].z; a[k].w += c[k].w;
    }
    if (whole) {
      reinterpret_cast<float4*>(pr)[0] = a[0];
      reinterpret_cast<float4*>(pr)[1] = a[1];
    } else {
      const float* af = reinterpret_cast<const float*>(a);
      for (int k = 0; k < 8; ++k)
        if (col + k < d) pr[k] = af[k];
    }
    m.x ^= 1u; v.y ^= 1u; e ^= 1u;
    *reinterpret_cast<uint2*>(mq + code) = m;
    *reinterpret_cast<uint2*>(vq + code) = v;
    *reinterpret_cast<uint16_t*>(mef + code / 4) = e;
    if (lane == 0) { ms[blk] = sm + 1.0f; vs[blk] = sv + 1.0f; }
  }
}
extern "C" int copy_q8_launch(void* p, const void* g, void* mq, void* ms,
                              void* mef, void* vq, void* vs, long long rows,
                              long long d, long long nb, long long grid,
                              void* stream) {
  copy_q8<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (int8_t*)mq, (float*)ms, (uint8_t*)mef,
      (uint8_t*)vq, (float*)vs, rows, d, nb);
  return (int)cudaGetLastError();
}
"""
# the copy kernel's grids: thread blocks of 8 warps an SM (None: a block
# for every 8 pairs, one pair a warp)
COPY_BLOCKS_PER_SM = (3, 8, None)


def variant_dir(name: str, ref) -> Path:
    """A copy of csrc/ with the variant's edits (or the --ref file),
    under build/ab_adamw/."""
    out = OUT / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", out / "csrc")
    target = out / "csrc" / SRC
    if name == "ref":
        shutil.copy(ref, target)
        return out
    for old, new in VARIANTS[name]:
        text = target.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {SRC} holds {old!r} "
                             f"{text.count(old)} times, not once")
        target.write_text(text.replace(old, new))
    return out


_SOURCE = {}      # the source of the adamw library in use


def use(build, name: str) -> Path:
    """Point kernels/build.py at the variant's sources, and the int8
    launch at its grid; its library."""
    from repro_torch.kernels import adamw
    BLOCKS_PER_SM.setdefault("base", adamw.Q8_BLOCKS_PER_SM)
    adamw.Q8_BLOCKS_PER_SM = BLOCKS_PER_SM.get(name, BLOCKS_PER_SM["base"])
    build.CSRC = OUT / name / "csrc"
    _SOURCE["adamw.cu"] = build.CSRC / SRC
    build.BUILD_DIR = OUT / name / "lib"
    build._LIBS.pop("adamw", None)
    return build.lib_path("adamw")


def older_q8(build):
    """Wrap build.load so that the adamw_q8 of an older adamw.cu (without
    the thresholds argument, or without the grid argument) is called with
    the arguments it takes."""
    load = build.load

    def compat(name, fn, argtypes):
        if fn != "adamw_q8":
            return load(name, fn, argtypes)
        text = " ".join(_SOURCE["adamw.cu"].read_text().split())
        keep = [True] * len(argtypes)       # ..., thresholds, grid, stream
        keep[-3] = "const float* thresholds" in text
        keep[-2] = "long long grid, void* stream" in text
        f = load(name, fn, [t for t, k in zip(argtypes, keep) if k])
        return lambda *a: f(*[x for x, k in zip(a, keep) if k])
    return compat


def q8_registers(log: str):
    """(registers, spill bytes) of adamw_q8_kernel from ptxas -v."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "adamw_q8_kernel" in ln:
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    spill = re.search(r"(\d+) bytes spill stores", log[
                        log.index(ln):])
                    return int(m.group(1)), int(spill.group(1)) if spill \
                        else 0
    return None, None


def blocks_per_sm(regs: int) -> int:
    """8-warp blocks an H100 SM holds at `regs` registers a thread."""
    per_warp = math.ceil(regs * 32 / 256) * 256
    return min(8, (65536 // per_warp) // 8)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def in_step(name: str) -> int:
    """The qwen int8 training step (train_step_profile.py's `qwen-int8`)
    with the variant's adamw library, built before by this tool; the
    step's other kernels build and load as usual."""
    import ctypes
    import importlib.util

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    csrc, lib_dir = build.CSRC, build.BUILD_DIR
    lib = use(build, name)
    build.CSRC, build.BUILD_DIR = csrc, lib_dir
    build._LIBS["adamw"] = ctypes.CDLL(str(lib))
    build.load = older_q8(build)
    spec = importlib.util.spec_from_file_location(
        "train_step_profile", ROOT / "tools" / "train_step_profile.py")
    tsp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tsp)
    tsp.profile_case(torch, cs, "qwen-int8", torch.device("cuda", 0),
                     nvidia_smi())
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("adamw_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import ctypes

    from torch.utils import _pytree as pytree

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw, build
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import bias_corrections
    from repro_torch.roofline import kernels as cost

    args = sys.argv[1:]
    if args[:1] == ["--in-step"]:
        return in_step(args[1])
    step = "--step" in args
    if step:
        args.remove("--step")
    ref = None
    if "--ref" in args:
        i = args.index("--ref")
        ref = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    names = args or (list(VARIANTS) + (["ref"] if ref else []))
    if "ref" in names and ref is None:
        raise SystemExit("adamw_ab: variant ref needs --ref FILE")
    for name in names:       # every edit checked before any build starts
        variant_dir(name, ref)
    procs = []
    for name in names:       # one nvcc a variant, all at once
        lib = use(build, name)
        lib.parent.mkdir(parents=True)
        procs.append((name, lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(build.CSRC / SRC)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    copy_so = OUT / "copy" / "copy_q8.so"
    copy_so.parent.mkdir(parents=True, exist_ok=True)
    (OUT / "copy" / "copy_q8.cu").write_text(COPY_CU)
    procs.append(("copy", copy_so, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(copy_so),
         str(OUT / "copy" / "copy_q8.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)))
    failed = False           # every nvcc waited for, failed or not
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc exit {proc.returncode}\n{log}")
            failed = True
        elif name != "copy":
            regs, spill = q8_registers(log)
            print(f"{name}: adamw_q8_kernel {regs} registers, {spill} "
                  f"bytes spilled, {blocks_per_sm(regs) if regs else '?'} "
                  f"blocks of 8 warps an SM", flush=True)
    if failed:
        return 1
    build.load = older_q8(build)
    copy = ctypes.CDLL(str(copy_so)).copy_q8_launch
    copy.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p]
    copy.restype = ctypes.c_int
    sms = build.sm_count(0)

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} ({card})", flush=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    step = torch.full((), 7, dtype=torch.int32, device=dev)
    lr, c1, c2 = bias_corrections(step, AdamWConfig(), LR)
    factor = torch.full((), 0.625, dtype=torch.float32, device=dev)

    def start_of(shape, moments, sparse=False):
        p, g, m = (torch.randn(shape, generator=gen, device=dev) * sc
                   for sc in (1.0, 1e-2, 1e-3))
        v = torch.rand(shape, generator=gen, device=dev) * 1e-5
        if sparse:
            dead = torch.arange(shape[0], device=dev) % SPARSE_EVERY != 0
            for t in (g, m, v):
                t[dead] = 0.0
        if moments == "int8":
            return g, [p, adamw.encode_m(m), adamw.encode_v(v)]
        return g, [p, m, v]

    def timed(shape, moments, g, start, check):
        """(ms, bound ms, moments equal plain, p equal base or None)."""
        kw = dict(lr=lr, c1=c1, c2=c2, cfg=AdamWConfig(moment_dtype=moments),
                  factor=factor)
        work = pytree.tree_map(torch.clone, start)
        t = cs.Timing(torch, lambda i: adamw.adamw_leaf_cuda(
            work[0], g, *work[1:], **kw), ITERS)
        bms = cost.bound_ms(cost.adamw_update_of(start[0], start[1]))[0]
        same = p_base = None
        if check:
            got, want = (pytree.tree_map(torch.clone, start)
                         for _ in range(2))
            adamw.adamw_leaf_cuda(got[0], g, *got[1:], **kw)
            adamw.adamw_leaf_plain(want[0], g, *want[1:], **kw)
            same = all(torch.equal(a, b) for a, b in zip(
                pytree.tree_leaves(got[1:]), pytree.tree_leaves(want[1:])))
            p_base = got[0]
        return t.ms, bms, same, p_base

    def copy_ms(g, start):
        """{blocks an SM: the copy kernel's ms} over an int8 leaf."""
        work = pytree.tree_map(torch.clone, start)
        d = start[0].shape[-1] if start[0].dim() else 1
        rows = start[0].numel() // d
        nb = -(-d // adamw.BLOCK)
        ptrs = [work[0].data_ptr(), g.data_ptr(),
                work[1]["q"].data_ptr(), work[1]["scale"].data_ptr(),
                work[1]["ef"].data_ptr(), work[2]["q"].data_ptr(),
                work[2]["scale"].data_ptr()]
        every = -(-rows * nb // 8)
        out = {}
        for per_sm in COPY_BLOCKS_PER_SM:
            grid = every if per_sm is None else min(every, sms * per_sm)
            # the current stream at each call: Timing captures on its own
            out[per_sm] = cs.Timing(torch, lambda i: copy(
                *ptrs, rows, d, nb, grid,
                torch.cuda.current_stream().cuda_stream), ITERS).ms
        return out

    base_p = {}
    for label, shape, moments in CASES:
        g, start = start_of(shape, moments, label == SPARSE)
        for name in names:
            use(build, name)
            ms, bms, same, p = timed(shape, moments, g, start, True)
            key = (label, shape, moments)
            if name == "base":
                base_p[key] = p
            p_eq = (torch.equal(p, base_p[key]) if key in base_p
                    else None)
            note = " (inexact by design)" if name in INEXACT else ""
            print(f"{name}: {label} {shape} {moments}: {ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({ms / bms:.2f}x); moments and codes equal "
                  f"plain {same}, p equal base {p_eq}{note}", flush=True)
        if moments == "int8":
            bms = cost.bound_ms(cost.adamw_update_of(start[0], start[1]))[0]
            got = copy_ms(g, start)
            print(f"copy (the int8 path's bytes): {label} {shape}: "
                  + ", ".join(f"{'one pair a warp' if k is None else k} "
                              f"blocks an SM {ms:.4f} ms"
                              for k, ms in got.items())
                  + f"; least {min(got.values()):.4f} ms, bound {bms:.4f} "
                  f"ms ({min(got.values()) / bms:.2f}x)", flush=True)
        del g, start

    # the qwen int8 step's leaves, each distinct shape timed once
    arch, layers = STEP
    cfg = get_config(arch).replace(n_layers=layers)
    shapes = Counter(tuple(t.shape) for t in pytree.tree_leaves(
        init_params(cfg, device="meta")))
    print(f"{arch} {layers} layers, int8 moments: {sum(shapes.values())} "
          f"leaves, {len(shapes)} shapes", flush=True)
    totals = {name: 0.0 for name in names}
    bound = floor = 0.0
    for shape, count in sorted(shapes.items(), key=lambda kv: -math.prod(
            kv[0])):
        g, start = start_of(shape, "int8")
        row = []
        for name in names:
            use(build, name)
            ms, bms, _, _ = timed(shape, "int8", g, start, False)
            totals[name] += count * ms
            row.append(f"{name} {ms:.4f}")
        bound += count * bms
        least = min(copy_ms(g, start).values())
        floor += count * least
        print(f"  {shape} x{count}: bound {bms:.4f} ms, copy {least:.4f} "
              f"ms; " + ", ".join(row), flush=True)
        del g, start
    for name in names:
        print(f"{name}: qwen int8 step's AdamW {totals[name]:.3f} ms, bound "
              f"{bound:.3f} ms ({totals[name] / bound:.2f}x), copy "
              f"{floor:.3f} ms ({totals[name] / floor:.2f}x) ({card})",
              flush=True)
    for name in (names + names[::-1]) if step else ():
        run = subprocess.run([sys.executable, __file__, "--in-step", name],
                             capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
        if run.returncode:
            lines.append(f"exit {run.returncode}: {run.stderr[-2000:]}")
        for ln in lines:
            print(f"{name} (in the step): {ln}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
