#!/usr/bin/env python3
"""Where the time of the bf16 flash-attention backward goes, on one CUDA
card: each variant is `src/repro_torch/csrc/flash_attention_bwd.cu` with
one edit (or the split planner overridden), built into its own library
and timed at chip_smoke.py's backward shapes (BWD_CASES).

    python3 tools/flash_bwd_ab.py [variant ...]    # default: all, base first

Per shape and variant it prints chip_smoke.Timing (median and min-max of
5 CUDA-event windows over graph replays), the device time of each of the
three kernels from torch.profiler (A: dQ and D; B: dK and dV; C: the
split sum), the split count, and max|d| against the plain version's
autograd with whether chip_smoke's bf16 BWD_TOL held.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SRC = "flash_attention_bwd.cu"
A_SUB = "  constexpr int SUB = KD == 8 ? 64 : kSub;"
B_SUB = "  constexpr int SUB = kSub;  // queries of S^T a warp holds at once"
B_LOOP = "#pragma unroll 1\n    for (int sub = 0; sub < kTile / SUB; ++sub) {"
A_BOUNDS = "__launch_bounds__(kTcThreads, 2)\n    flash_bwd_dq_tc("
B_BOUNDS = ("__launch_bounds__(kTcThreads, KD <= 4 ? 3 : 2)\n"
            "    flash_bwd_dkdv_tc(")
# name: (source edits [(old, new)], nsplit override: plan -> nsplit or None)
VARIANTS = {
    "base": ([], None),
    "split-1": ([], lambda plan, most: 1),
    "split-2x": ([], lambda plan, most: min(most, 2 * plan.nsplit)),
    "a-sub32": ([(A_SUB, A_SUB.replace("KD == 8 ? 64 : kSub", "kSub"))],
                None),
    "b-sub16": ([(B_SUB, B_SUB.replace("kSub", "16"))], None),
    "b-unrolled": ([(B_LOOP, B_LOOP.replace(" 1", "", 1))], None),
}
for n in (3, 4):        # blocks an SM at hd <= 64 (the registers' bound)
    VARIANTS[f"a-minb{n}"] = ([(A_BOUNDS, A_BOUNDS.replace(
        "2)", f"KD <= 4 ? {n} : 2)"))], None)
for n in (2, 4):
    VARIANTS[f"b-minb{n}"] = ([(B_BOUNDS, B_BOUNDS.replace(
        "? 3 :", f"? {n} :"))], None)
OUT = ROOT / "build" / "ab_bwd"


def variant_dir(name: str) -> Path:
    """A copy of csrc/ with the variant's edits, under build/ab_bwd/."""
    out = OUT / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", out / "csrc")
    for old, new in VARIANTS[name][0]:
        text = (out / "csrc" / SRC).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {SRC} holds {old!r} "
                             f"{text.count(old)} times, not once")
        (out / "csrc" / SRC).write_text(text.replace(old, new))
    return out


def use(build, name: str) -> Path:
    """Point kernels/build.py at the variant's sources; its library
    path."""
    build.CSRC = OUT / name / "csrc"
    build.BUILD_DIR = OUT / name / "lib"
    build._LIBS.pop("flash_attention_bwd", None)
    return build.lib_path("flash_attention_bwd")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as flash

    names = sys.argv[1:] or list(VARIANTS)
    build.build(["flash_attention"])
    # the forward stays the checkout's
    build.load("flash_attention", "flash_attention", flash._ARGTYPES)
    procs = []
    for name in names:       # one nvcc a variant, all at once
        variant_dir(name)
        lib = use(build, name)
        lib.parent.mkdir(parents=True)
        procs.append((name, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(build.CSRC / SRC)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill" not in ln})
        print(f"{name}: nvcc exit {proc.returncode}; "
              f"{len(spills)} kernels spill {spills}", flush=True)
        if proc.returncode:
            print(log)
            return 1

    dev = torch.device("cuda", 0)
    sms = build.sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(19)
    cases = []
    for B, Tq, Tk, H, KV, hd, causal, window, tag in cs.BWD_CASES:
        q = torch.randn(B, Tq, H, hd, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Tk, KV, hd, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        do = torch.randn(B, Tq, H, hd, generator=gen, device=dev).bfloat16()
        _, lse = flash._forward(q, k, v, causal, window, with_lse=True)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(flash.flash_attention_plain(
            *leaves, causal=causal, window=window), leaves, do)
        # the planner's cap: the split it plans for a card without end
        most = flash.plan_bwd(B, Tq, Tk, H, KV, hd, 1 << 30).nsplit
        cases.append((f"{tag} B={B} Tq={Tq} Tk={Tk}", (q, k, v, do, lse),
                      dict(causal=causal, window=window), want,
                      (B, Tq, Tk, H, KV, hd), most))
    print(f"device: {torch.cuda.get_device_name(0)}, {sms} SMs", flush=True)
    rel_max, rel = cs.BWD_TOL["bfloat16"]
    planner = flash.plan_bwd
    for name in names:
        use(build, name)
        override = VARIANTS[name][1]
        for label, args, kw, want, shape, most in cases:
            plan = planner(*shape, sms)
            if override is not None:
                n = override(plan, most)
                flash.plan_bwd = lambda *a, n=n: flash.BwdPlan(
                    n, plan.blocks // plan.nsplit * n)
            call = lambda i: flash.flash_attention_bwd_cuda(*args, **kw)
            got = call(0)
            ok, gap = True, 0.0
            for a, b in zip(got, want):
                d = (a.float() - b.float()).abs()
                gap = max(gap, float(d.max()))
                ok &= bool((d <= rel_max * float(b.abs().max())
                            + rel * b.float().abs()).all())
            t = cs.Timing(torch, call, 20)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(5):
                    call(i)
                torch.cuda.synchronize()
            us = {}
            for e in prof.key_averages():
                for key, part in (("dq_tc", "A"), ("dkdv_tc", "B"),
                                  ("bwd_reduce", "C")):
                    if key in e.key:
                        us[part] = e.device_time_total / e.count
            flash.plan_bwd = planner
            n = plan.nsplit if override is None else override(plan, most)
            print(f"{name}: {label} nsplit {n} {t} (profiler us: "
                  + ", ".join(f"{p} {us[p]:.1f}" for p in sorted(us))
                  + f") max|d| {gap:.3e} ok {ok}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
