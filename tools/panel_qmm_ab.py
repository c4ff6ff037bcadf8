#!/usr/bin/env python3
"""Where the time of `comq_panel` and `quant_matmul` goes, on one CUDA
card: each variant below is the kernel sources of `src/repro_torch/csrc/`
with one change, built into its own library and timed at chip_smoke.py's
shapes.

    python3 tools/panel_qmm_ab.py [variant ...]    # default: all, in order

Shapes: comq_panel at B=256, n = 512, 3584 and 18944 (chip_smoke's random
panels, seed 1); quant_matmul 4-bit at M=8 (K, N) = (3584, 18944) with f32
and bf16 X, (18944, 3584) with f32 X (split K), and M=1024 (3584, 18944)
with f32 X. Times are chip_smoke.Timing (median and min-max of 5
CUDA-event windows over graph replays); the quant_matmul codes rotate
over copies past the 50 MB L2, as in chip_smoke. For the first variant
named, torch.profiler splits each quant_matmul call by kernel (X split,
main kernel, split-K epilogue). `panel-clock` reads clock64() in the chain
thread by phase. Variants that drop work give wrong outputs on purpose:
`agree` (panel codes equal to the plain version) and `rel`
(max|d|/max|y|) say how far each lands.
"""
from __future__ import annotations

import math
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

P, Q = "comq_panel.cu", "quant_matmul.cu"
MMA = "            mma_16816(acc[t][mt], a[t], b[mt][0], b[mt][1]);"
# name -> [(file, old, new), ...]
VARIANTS = {
    "base": [],
    "panel-sub-32": [(P, "constexpr int kSub = 16;",
                     "constexpr int kSub = 32;")],
    "panel-8-warps": [(P, "constexpr int kWarps = 4;",
                      "constexpr int kWarps = 8;")],
    "panel-no-trailing": [(P, "if (rows > kSub) {", "if (false) {")],
    "panel-always-redo": [(P, "if (__any_sync(kChainLanes, near)) {",
                           "if (true) {")],
    "panel-no-stores": [(P, "    if (tid >= 32) {   // the sub-panel's",
                         "    if (false) {   // the sub-panel's")],
    "panel-3-stages": [(P, "kStages = C >= 32 ? 2 : 3;",
                        "kStages = 3;")],
    "panel-cols-32": [(P, "  for (int c = 32; c > 4; c /= 2)",
                       "  return 32;\n  for (int c = 32; c > 4; c /= 2)")],
    "panel-cols-16": [(P, "  for (int c = 32; c > 4; c /= 2)",
                       "  return n > 512 ? 16 : 4;\n"
                       "  for (int c = 32; c > 4; c /= 2)")],
    # cycles of thread 0 of block 0 by phase of its sub-panels: loads and
    # reciprocals, the fast pass, the redo check, the results to shared
    # memory (written over the first codes of the output)
    "panel-clock": [
        (P, "  for (int p = 0; p < n_sub; ++p) {",
         "  long long clk[4] = {0, 0, 0, 0};\n"
         "  for (int p = 0; p < n_sub; ++p) {"),
        (P, "    if (tid < C) {\n      const float* qs = qrows(p);",
         "    const long long c0 = clock64();\n"
         "    if (tid < C) {\n      const float* qs = qrows(p);"),
        (P, "      bool near = false;\n",
         "      const long long c1 = clock64();\n      clk[0] += c1 - c0;\n"
         "      bool near = false;\n"),
        (P, "      if (__any_sync(kChainLanes, near)) {\n",
         "      const long long c2 = clock64();\n      clk[1] += c2 - c1;\n"
         "      if (__any_sync(kChainLanes, near)) {\n"),
        (P, "      // results to shared memory; the other warps store them\n",
         "      const long long c3 = clock64();\n      clk[2] += c3 - c2;\n"
         "      // results to shared memory; the other warps store them\n"),
        (P, """    }
    __syncthreads();
    if (tid >= 32) {   // the sub-panel's""", """      clk[3] += clock64() - c3;
    }
    __syncthreads();
    if (tid >= 32) {   // the sub-panel's"""),
        (P, """        *sp = a;
      }
    }
  }
}""", """        *sp = a;
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0)
    for (int i = 0; i < 4; ++i) qf_out[i] = (float)clk[i];
}""")],
    "qmm-no-mma": [(Q, MMA, "            acc[t][mt][0] += __uint_as_float("
                         "a[t][0] ^ b[mt][0]);")],
    "qmm-no-unpack": [(Q, "unpack_tile<CPB>(w, t, a[t]);",
                       "for (int i = 0; i < 4; ++i) a[t][i] = w[i] ^ t;")],
    "qmm-two-planes": [(Q, "rc = launch_cpb<3>(cpb, p.big, a, st);",
                        "rc = launch_cpb<2>(cpb, p.big, a, st);")],
    "qmm-no-code-copy": [(Q, "      copy_chunk(cs + code_off(",
                          "      if (false) copy_chunk(cs + code_off(")],
    "qmm-no-swizzle": [(Q, "(((byte >> 4) ^ (2 * ((r >> 2) & 3))) << 4)",
                        "((byte >> 4) << 4)"),
                       (Q, "((((wn * 32 + 4 * gid) >> 4) ^ (2 * tig)) << 4)",
                        "((((wn * 32 + 4 * gid) >> 4)) << 4)")],
    "qmm-decode-3-stages": [(Q, "using Cfg8 = Cfg<1, 1, 64, 4>;",
                             "using Cfg8 = Cfg<1, 1, 64, 3>;")],
    "qmm-decode-bk-128": [(Q, "using Cfg8 = Cfg<1, 1, 64, 4>;",
                           "using Cfg8 = Cfg<1, 1, 128, 3>;")],
    "qmm-ksplit-x2": [(Q, "cdiv(4LL * n_sm, tiles)",
                      "cdiv(8LL * n_sm, tiles)")],
}


def variant_dir(name: str) -> Path:
    """A copy of csrc/ with the variant's edits, under build/ab/."""
    out = ROOT / "build" / "ab" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", out)
    for fname, old, new in VARIANTS[name]:
        text = (out / fname).read_text()
        if old not in text:
            raise SystemExit(f"{name}: {fname} no longer holds {old!r}")
        (out / fname).write_text(text.replace(old, new))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("panel_qmm_ab: needs a CUDA card", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.core.quantizer import pack_codes
    from repro_torch.kernels import build
    from repro_torch.kernels import comq_panel as panel
    from repro_torch.kernels import quant_matmul as qmm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    names = sys.argv[1:] or list(VARIANTS) + ["base"]
    g = torch.Generator(device=dev).manual_seed(1)
    B = 256
    panels = []
    for n in (512, 3584, 18944):
        x = torch.randn(4 * B, B, generator=g, device=dev)
        h_bb = (x.T @ x) / (4 * B) + 0.1 * torch.eye(B, device=dev)
        args = (h_bb, torch.randn(B, n, generator=g, device=dev),
                torch.randn(B, n, generator=g, device=dev) * 3,
                torch.rand(n, generator=g, device=dev) * 0.15 + 0.05,
                torch.full((n,), -8.0, device=dev),
                torch.full((n,), 7.0, device=dev),
                torch.diagonal(h_bb).contiguous())
        panels.append((f"panel n={n}", args,
                       panel.comq_panel_dq_plain(*args)[0]))
    g = torch.Generator(device=dev).manual_seed(3)
    mats = []
    for M, K, N, xdt in ((8, 3584, 18944, torch.float32),
                         (8, 3584, 18944, torch.bfloat16),
                         (8, 18944, 3584, torch.float32),
                         (1024, 3584, 18944, torch.float32)):
        u = torch.randint(0, 16, (K, N), generator=g, device=dev,
                          dtype=torch.uint8)
        codes, cpb = pack_codes(u, 4)
        x = torch.randn(M, K, generator=g, device=dev).to(xdt)
        scale = torch.rand(N, generator=g, device=dev) * 0.04 + 0.01
        z = torch.randint(-8, 0, (N,), generator=g, device=dev).float()
        n_copy = min(64, max(2, math.ceil(128e6 / codes.numel())))
        copies = [codes.clone() for _ in range(n_copy)]
        want = qmm.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
        mats.append((f"qmm M={M} K={K} N={N} x={str(xdt)[6:]}",
                     (x, copies, scale, z, cpb), want))
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    for name in names:
        build.CSRC = variant_dir(name)
        build._LIBS.clear()
        build.build(["comq_panel", "quant_matmul"])
        qmm.plan.cache_clear()
        cells = []
        for label, args, want in panels:
            q_out = panel.comq_panel_dq_cuda(*args)[0]
            agree = float((q_out == want).float().mean())
            if name == "panel-clock":   # thread 0 of block 0
                clk = [int(v) for v in q_out[0, :4].tolist()]
                label += (f" clock64 loads/fast pass/redo check/results "
                          f"{clk}")
            t = cs.Timing(torch, lambda i: panel.comq_panel_dq_cuda(*args),
                          20)
            cells.append(f"{label} {t} agree {agree:.6f}")
        for label, (x, copies, scale, z, cpb), want in mats:
            got = qmm.quant_matmul_cuda(x, copies[0], scale, z, cpb=cpb)
            rel = float((got - want).abs().max() / want.abs().max())
            t = cs.Timing(torch, lambda i: qmm.quant_matmul_cuda(
                x, copies[i % len(copies)], scale, z, cpb=cpb), 20)
            split = qmm.plan(x.shape[0], x.shape[1], copies[0].shape[1],
                             cpb, x.dtype == torch.bfloat16,
                             build.sm_count(0))[1]
            cell = f"{label} {t} rel {rel:.3e} ksplit {split}"
            if name == names[0]:
                # device time by kernel (split / main / epilogue); only for
                # the first variant: later profiler sessions in the same
                # process lose events
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for i in range(10):
                        qmm.quant_matmul_cuda(x, copies[i % len(copies)],
                                              scale, z, cpb=cpb)
                    torch.cuda.synchronize()
                parts = {}
                for e in prof.key_averages():
                    found = re.search(r"qmm_\w+", e.key)
                    if found:
                        parts[found.group(0)] = (parts.get(found.group(0), 0)
                                                 + e.device_time_total / 10)
                cell += " (profiler us: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in parts.items()) + ")"
            cells.append(cell)
        print(f"{name}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
