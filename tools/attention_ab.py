#!/usr/bin/env python3
"""Where the time of the two tensor-core attention kernels goes, on one
CUDA card: each variant below is the kernel sources of
`src/repro_torch/csrc/` with one change, built into its own library and
timed at chip_smoke.py's shapes.

    python3 tools/attention_ab.py [variant ...]    # default: all, in order

Shapes: flash_attention bf16 causal at B=8, T=128 and B=1, T=512 (H=28,
KV=4, hd=128); paged_attention bf16 at the check shape of chip_smoke.py
(8 slots, lengths up to 4096, 1090 live 16-token pages, seed 4) and at
serve-like lengths (8 slots, 64-544 tokens). Times are chip_smoke.Timing
(median and min-max of 5 CUDA-event windows over graph replays) and the
per-kernel device time from torch.profiler. Variants that drop work give
wrong outputs on purpose: `max|d|` and `ok` say how far from the plain
version each lands and whether the bf16 tolerance held.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

F, P, H = "flash_attention.cu", "paged_attention.cu", "mma_bf16.cuh"
# name -> ([(file, old, new), ...], paged split tokens)
VARIANTS = {
    "base": ([], 256),
    "flash-no-kv-load": ([(F, "auto load_tile = [&](int stage, int kt) {",
                           "auto load_tile = [&](int stage, int kt) {"
                           " return;")], 256),
    "flash-no-s-mma": ([(F, """        mma_16816(s[2 * j], a, bk[j][0], bk[j][1]);
        mma_16816(s[2 * j + 1], a, bk[j][2], bk[j][3]);""", "")], 256),
    "flash-no-pv": ([(F, "      pv_split<KD>(acc, s[2 * j], s[2 * j + 1], "
                         "v_lane + 16 * j * LDB);", "      ;")], 256),
    "p-bf16-only": ([(H, """    mma_16816(acc[2 * n], lo, bn[0], bn[1]);
    mma_16816(acc[2 * n + 1], lo, bn[2], bn[3]);""", "")], 256),
    "flash-3-stages": ([(F, "constexpr int kTcStages = 2;",
                         "constexpr int kTcStages = 3;")], 256),
    "flash-no-min-blocks": ([(F, "__launch_bounds__(kTcWarps * 32, 2)",
                              "__launch_bounds__(kTcWarps * 32)")], 256),
    "paged-no-kv-load": ([(P, "auto load_tile = [&](int stage, int t0) {",
                           "auto load_tile = [&](int stage, int t0) {"
                           " return;")], 256),
    "paged-no-compute": ([(P, "if (16 * warp >= n) continue;",
                           "continue;")], 256),
    "split-128": ([], 128),
    "split-384": ([], 384),
}


def variant_dir(name: str) -> Path:
    """A copy of csrc/ with the variant's edits, under build/ab/."""
    edits, _ = VARIANTS[name]
    out = ROOT / "build" / "ab" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", out)
    for fname, old, new in edits:
        text = (out / fname).read_text()
        if old not in text:
            raise SystemExit(f"{name}: {fname} no longer holds {old!r}")
        (out / fname).write_text(text.replace(old, new))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import paged_attention as paged

    dev = torch.device("cuda", 0)
    names = sys.argv[1:] or list(VARIANTS) + ["base"]
    g = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd = 28, 4, 128
    flash_in = []
    for B, T in ((8, 128), (1, 512)):
        q, k, v = (torch.randn(B, T, n, hd, generator=g, device=dev)
                   .bfloat16() for n in (H, KV, KV))
        flash_in.append((f"flash B={B} T={T}", (q, k, v),
                         flash.flash_attention_plain(q, k, v).float()))
    g = torch.Generator(device=dev).manual_seed(4)
    B, BS, MAXB = 8, 16, 256
    NB = B * MAXB
    lens = torch.randint(1, MAXB * BS + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[3] = 0
    bt = torch.randperm(NB, generator=g, device=dev).reshape(B, MAXB).to(
        torch.int32)
    q = torch.randn(B, H, hd, generator=g, device=dev).bfloat16()
    pools = [tuple(torch.randn(NB, BS, KV, hd, generator=g, device=dev)
                   .bfloat16() for _ in range(2))]
    pools.append(tuple(p.clone() for p in pools[0]))   # > 50 MB L2 apart
    serve_lens = torch.randint(64, 545, (B,), generator=g, device=dev,
                               dtype=torch.int32)
    paged_in = [(f"paged {tag}", ln, paged.paged_attention_plain(
        q, *pools[0], bt, ln).float()) for tag, ln in
        (("check", lens), ("serve", serve_lens))]
    print(f"device: {torch.cuda.get_device_name(0)}; paged check lengths "
          f"{lens.tolist()}, serve lengths {serve_lens.tolist()}",
          flush=True)

    def close(got, want):
        """max|d| and whether the bf16 tolerance holds everywhere"""
        d = (got.float() - want).abs()
        ok = bool((d <= 8e-3 * want.abs() + 1e-3).all())
        return f"{float(d.max()):.3e} ok {ok}"

    for name in names:
        build.CSRC = variant_dir(name)
        build._LIBS.clear()
        paged._SPLIT_TOKENS = VARIANTS[name][1]
        build.build(["flash_attention", "paged_attention"])
        cells = []
        for label, args, want in flash_in:
            gap = close(flash.flash_attention_cuda(*args), want)
            t = cs.Timing(torch, lambda i: flash.flash_attention_cuda(*args),
                          50)
            cells.append(f"{label} {t} max|d| {gap}")
        for label, ln, want in paged_in:
            gap = close(paged.paged_attention_cuda(q, *pools[0], bt, ln),
                        want)
            t = cs.Timing(torch, lambda i: paged.paged_attention_cuda(
                q, *pools[i % 2], bt, ln), 50)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(10):
                    paged.paged_attention_cuda(q, *pools[i % 2], bt, ln)
                torch.cuda.synchronize()
            split_us = {("combine" if "combine" in e.key else "split"):
                        e.device_time_total / e.count
                        for e in prof.key_averages() if "paged_" in e.key}
            cells.append(f"{label} {t} max|d| {gap} (profiler: split "
                         f"{split_us.get('split', 0):.2f} us, combine "
                         f"{split_us.get('combine', 0):.2f} us)")
        print(f"{name}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
