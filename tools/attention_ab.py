#!/usr/bin/env python3
"""Where the time of the tensor-core attention kernels goes, on one CUDA
card: each variant below is the kernel sources of `src/repro_torch/csrc/`
with one change, built into its own library and timed at chip_smoke.py's
shapes.

    python3 tools/attention_ab.py [variant ...]    # default: all, in order

Shapes: flash_attention bf16 causal at B=8, T=128 and B=1, T=512 (H=28,
KV=4, hd=128); paged_attention bf16 at the check shape of chip_smoke.py
(8 slots, lengths up to 4096, 1090 live 16-token pages, seed 4) and at
serve-like lengths (8 slots, 64-544 tokens); paged_attention_quant with
bf16 q over int8 and 4-bit codes of the same pages at both lengths. A
variant times the groups it names (flash, paged, quant). Times are
chip_smoke.Timing (median and min-max of 5 CUDA-event windows over graph
replays, pool copies rotated past the 50 MB L2) and the per-kernel device
time from torch.profiler. Variants that drop work give wrong outputs on
purpose: `max|d|` and `ok` say how far from the plain version each lands
and whether the bf16 tolerance held.
"""
from __future__ import annotations

import math
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

F, P, H = "flash_attention.cu", "paged_attention.cu", "mma_bf16.cuh"
FP, Q = ("flash", "paged"), ("quant",)
V_TILE = """    {
      bf16* vw = vt + warp * 16 * LD;
      for (int i = lane; i < 16 * (CB / 4); i += 32) {
        const int r = i / (CB / 4), c = i % (CB / 4);
        const uint32_t wv =
            *reinterpret_cast<const uint32_t*>(v_w + r * RS + 4 * c);
        if constexpr (KIND == kInt8) {
          const uint32_t u = wv ^ 0x80808080u;
          *reinterpret_cast<uint2*>(vw + r * LD + 4 * c) =
              make_uint2(bf16_pair(int8_f32(u, 0), int8_f32(u, 1)),
                         bf16_pair(int8_f32(u, 2), int8_f32(u, 3)));
        } else {
          uint32_t o[4];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const uint32_t x = __byte_perm(wv, 0u, bb | (bb << 8));
            o[bb] = nib_pair((x & 0xFFu) | ((x >> 4) & 0x00FF0000u));
          }
          *reinterpret_cast<uint4*>(vw + r * LD + 8 * c) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
      __syncwarp();
      pv_split<KD>(acc, s[0], s[1], lane_addr_a(smem_u32(vw), 2 * LD, lane));
      __syncwarp();
      continue;
    }
"""
# name -> ([(file, old, new), ...], paged split tokens, groups timed)
VARIANTS = {
    "base": ([], 256, FP + Q),
    "flash-no-kv-load": ([(F, "auto load_tile = [&](int stage, int kt) {",
                           "auto load_tile = [&](int stage, int kt) {"
                           " return;")], 256, FP),
    "flash-no-s-mma": ([(F, """        mma_16816(s[2 * j], a, bk[j][0], bk[j][1]);
        mma_16816(s[2 * j + 1], a, bk[j][2], bk[j][3]);""", "")], 256, FP),
    "flash-no-pv": ([(F, "      pv_split<KD>(acc, s[2 * j], s[2 * j + 1], "
                         "v_lane + 16 * j * LDB);", "      ;")], 256, FP),
    "p-bf16-only": ([(H, """    mma_16816(acc[2 * n], lo, bn[0], bn[1]);
    mma_16816(acc[2 * n + 1], lo, bn[2], bn[3]);""", "")], 256, FP),
    "flash-3-stages": ([(F, "constexpr int kTcStages = 2;",
                         "constexpr int kTcStages = 3;")], 256, FP),
    "flash-no-min-blocks": ([(F, "__launch_bounds__(kTcWarps * 32, 2)",
                              "__launch_bounds__(kTcWarps * 32)")], 256, FP),
    "paged-no-kv-load": ([(P, "    bf16* dst = kv_s + stage * 2 * kTK * LD;",
                           "    return;\n    bf16* dst = kv_s;")], 256, FP),
    "paged-no-compute": ([(P, "s_hi - (s_lo + it * kTK));\n"
                              "    if (16 * warp >= n) continue;",
                           "s_hi - (s_lo + it * kTK));\n    continue;")],
                         256, FP),
    "split-128": ([], 128, FP),
    "split-384": ([], 384, FP),
    # paged_attention_quant, bf16 q over codes
    "quant-cuda-core": ([], 256, Q),    # the PR 14 CUDA-core kernel
    # the other V-fragment design: each warp widens its 16 V code rows
    # into its own bf16 tile (natural dim order), then the bf16 kernel's
    # ldmatrix + pv_split
    "quant-v-tile": ([
        (P, "  return (ring > o_s ? ring : o_s) + sizeof(bf16) * 16 * (HD + "
            "kRowPad) +",
         "  return (ring > o_s ? ring : o_s) + sizeof(bf16) * (16 + kWarps "
         "* 16) * (HD + kRowPad) +"),
        (P, "  float* ml_s = reinterpret_cast<float*>(qs + 16 * LD);  // "
            "[kWarps][16][2]\n  float* kscl",
         "  bf16* vt = qs + 16 * LD;  // [kWarps][16][LD]\n"
         "  float* ml_s = reinterpret_cast<float*>(vt + kWarps * 16 * LD);\n"
         "  float* kscl"),
        (P, "    // P split into bf16 hi + lo as the A fragment; the V "
            "fragments pair\n", V_TILE + "    // P split into bf16 hi + lo "
            "as the A fragment; the V fragments pair\n"),
        (P, "[](int d) { return acc_pos<KIND>(d); }",
         "[](int d) { return d; }")], 256, Q),
    "quant-no-unpack": ([
        (P, """  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | b)) -
         8388736.f;""", "  return __uint_as_float(u + b);"),
        (P, "  const uint32_t x = (t & 0x000F000Fu) | 0x43004300u;",
         "  return t;\n  const uint32_t x = t;")], 256, Q),
    "quant-no-scale-fold": ([
        (P, "      kscl[j] = ok ? scale_log2 * a.ks[si] : 0.f;\n"
            "      vscl[j] = ok ? a.vs[si] : 0.f;", "      (void)si;"),
        (P, "s[t][e] = j < n ? s[t][e] * kscl[jt + j] : -INFINITY;",
         "s[t][e] = j < n ? s[t][e] * scale_log2 : -INFINITY;"),
        (P, "s[t][e] = j < n ? s[t][e] * vscl[jt + j] : 0.f;",
         "s[t][e] = j < n ? s[t][e] : 0.f;")], 256, Q),
    # the scales copied by cp.async with tile 0, raw (times scale_log2 at
    # the score)
    "quant-scales-by-cp-async": ([
        (P, "      kscl[j] = ok ? scale_log2 * a.ks[si] : 0.f;\n"
            "      vscl[j] = ok ? a.vs[si] : 0.f;", "      (void)si;"),
        (P, """(a zero row with scale 0)
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int j = tid + i * kThreads, kpos = split * span + j;
    if (j < span)
      rows_s[j] = page[i] >= 0 && page[i] < a.NB
                      ? (page[i] * a.BS + kpos % a.BS) * a.KV + kv
                      : -1;""", """(a zero row with scale 0)
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int j = tid + i * kThreads, kpos = split * span + j;
    if (j < span) {
      const bool ok = page[i] >= 0 && page[i] < a.NB;
      const size_t si = ok ? (size_t)page[i] * a.KV + kv : 0;
      rows_s[j] = ok ? (page[i] * a.BS + kpos % a.BS) * a.KV + kv : -1;
      cp_async<4>(smem_u32(kscl + j), a.ks + si, ok);
      cp_async<4>(smem_u32(vscl + j), a.vs + si, ok);
    }"""),
        (P, "s[t][e] = j < n ? s[t][e] * kscl[jt + j] : -INFINITY;",
         "s[t][e] = j < n ? s[t][e] * (scale_log2 * kscl[jt + j]) "
         ": -INFINITY;")], 256, Q),
    "quant-2-stages": ([(P, "constexpr int kQuantStages = 3;",
                         "constexpr int kQuantStages = 2;")], 256, Q),
    "quant-4-stages": ([(P, "constexpr int kQuantStages = 3;",
                         "constexpr int kQuantStages = 4;")], 256, Q),
    # 4 blocks an SM (registers <= 128): the grid's 512 blocks in one wave
    "quant-4-blocks": ([(P, "__launch_bounds__(kThreads)\n    paged_split_tcq_kernel", "__launch_bounds__(kThreads, 4)\n    paged_split_tcq_kernel")], 256, Q),
    "quant-4-blocks-2-stages": ([(P, "__launch_bounds__(kThreads)\n    paged_split_tcq_kernel", "__launch_bounds__(kThreads, 4)\n    paged_split_tcq_kernel"),
                                 (P, "constexpr int kQuantStages = 3;",
                                  "constexpr int kQuantStages = 2;")], 256,
                                Q),
    "quant-q-from-smem": ([(P, "  constexpr bool kQInRegs = KD <= 8;\n"
                               "  static_assert(HD % (8 * VPW)",
                            "  constexpr bool kQInRegs = false;\n"
                            "  static_assert(HD % (8 * VPW)")], 256, Q),
    # clock64 in thread 0 of block (split 0, kv 0, slot 1), first launch
    # of each code width: prologue, tile waits, tile compute, merge
    "quant-clock": ([
        (P, "template <int KD, int KIND>\n__global__ void __launch_bounds__("
            "kThreads)\n    paged_split_tcq_kernel",
         "__device__ int g_clock_printed[4];\n"
         "template <int KD, int KIND>\n__global__ void __launch_bounds__("
         "kThreads)\n    paged_split_tcq_kernel"),
        (P, "  const int span = a.pps * a.BS;\n  constexpr int kKeysPerThread",
         "  const long long c0 = clock64();\n"
         "  const bool clk = tid == 0 && blockIdx.x == 0 && blockIdx.y == 0"
         " && blockIdx.z == 1;\n"
         "  const int span = a.pps * a.BS;\n  constexpr int kKeysPerThread"),
        (P, "  const int cpr = a.row_bytes / w;  // cp.async chunks per row\n"
            "  // keys [t0",
         "  const long long c1 = clock64();\n"
         "  const int cpr = a.row_bytes / w;  // cp.async chunks per row\n"
         "  // keys [t0"),
        (P, "  for (int it = 0; it < n_tiles; ++it) {\n"
            "    cp_async_wait<kQuantStages - 2>();",
         "  const long long c2 = clock64();\n  long long cw = 0;\n"
         "  for (int it = 0; it < n_tiles; ++it) {\n"
         "    const long long cl = clock64();\n"
         "    cp_async_wait<kQuantStages - 2>();"),
        (P, "    __syncthreads();  // ... for every thread; stage (it - 1) % S "
            "is free\n",
         "    __syncthreads();  // ... for every thread; stage (it - 1) % S "
         "is free\n    cw += clock64() - cl;\n"),
        (P, "  merge_warps<KD>(a, acc, m, l, o_s, ml_s, part, tid,\n"
            "                  [](int d) { return acc_pos<KIND>(d); });\n",
         "  const long long c3 = clock64();\n"
         "  merge_warps<KD>(a, acc, m, l, o_s, ml_s, part, tid,\n"
         "                  [](int d) { return acc_pos<KIND>(d); });\n"
         "  const long long c4 = clock64();\n"
         "  if (clk && atomicAdd(&g_clock_printed[KIND], 1) == 0)\n"
         "    printf(\"clock kind %d tiles %d: to the table sync %lld, to the"
         " loop %lld, tile waits %lld, tile compute %lld, merge %lld "
         "cycles\\n\", KIND, n_tiles, c1 - c0, c2 - c1, cw, c3 - c2 - cw,"
         " c4 - c3);\n")], 256, Q),
    "quant-no-kv-load": ([(P, "    uint8_t* dst = ring + stage * 2 * kTK * RS;",
                           "    return;\n    uint8_t* dst = ring;")], 256, Q),
}


def variant_dir(name: str) -> Path:
    """A copy of csrc/ with the variant's edits, under build/ab/."""
    edits = VARIANTS[name][0]
    out = ROOT / "build" / "ab" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", out)
    for fname, old, new in edits:
        text = (out / fname).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {fname} holds {old!r} "
                             f"{text.count(old)} times, not once")
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
    from repro_torch.serve.kv_cache import kv_encode, kv_scale_of
    quant_in = []       # (label, lengths, kv_bits, pool copies, want)
    for kv_bits in (8, 4):
        codes = []
        for pool in pools[0]:
            s = kv_scale_of(pool.float().abs().amax(dim=(1, 3)), kv_bits)
            codes += [kv_encode(pool.float(), s[:, None], kv_bits),
                      s.contiguous()]
        kq, ks, vq, vs = codes
        n_copy = max(2, math.ceil(160e6 / (2 * kq.numel())))
        copies = [(kq.clone(), vq.clone(), ks, vs) for _ in range(n_copy)]
        for tag, ln in (("check", lens), ("serve", serve_lens)):
            quant_in.append((f"quant {kv_bits}-bit {tag}", ln, kv_bits,
                             copies, paged.paged_attention_quant_plain(
                                 q, kq, vq, ks, vs, bt, ln,
                                 kv_bits=kv_bits).float()))
    print(f"device: {torch.cuda.get_device_name(0)}; paged check lengths "
          f"{lens.tolist()}, serve lengths {serve_lens.tolist()}",
          flush=True)

    def close(got, want):
        """max|d| and whether the bf16 tolerance holds everywhere"""
        d = (got.float() - want).abs()
        ok = bool((d <= 8e-3 * want.abs() + 1e-3).all())
        return f"{float(d.max()):.3e} ok {ok}"

    def paged_cell(label, call, want):
        """call(i) runs on pool copy i: time it, and split / combine from
        the profiler"""
        gap = close(call(0), want)
        t = cs.Timing(torch, call, 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(10):
                call(i)
            torch.cuda.synchronize()
        split_us = {("combine" if "combine" in e.key else "split"):
                    e.device_time_total / e.count
                    for e in prof.key_averages() if "paged_" in e.key}
        return (f"{label} {t} max|d| {gap} (profiler: split "
                f"{split_us.get('split', 0):.2f} us, combine "
                f"{split_us.get('combine', 0):.2f} us)")

    route = paged.quant_kernel
    for name in names:
        edits, split, groups = VARIANTS[name]
        build.CSRC = variant_dir(name)
        build._LIBS.clear()
        paged._SPLIT_TOKENS = split
        paged.quant_kernel = (route if name != "quant-cuda-core" else
                              lambda *args: paged.CUDA_CORE)
        build.build(["flash_attention", "paged_attention"])
        cells = []
        if "flash" in groups:
            for label, args, want in flash_in:
                gap = close(flash.flash_attention_cuda(*args), want)
                t = cs.Timing(torch, lambda i: flash.flash_attention_cuda(
                    *args), 50)
                cells.append(f"{label} {t} max|d| {gap}")
        if "paged" in groups:
            for label, ln, want in paged_in:
                cells.append(paged_cell(
                    label, lambda i: paged.paged_attention_cuda(
                        q, *pools[i % 2], bt, ln), want))
        if "quant" in groups:
            for label, ln, kv_bits, copies, want in quant_in:
                def call(i):
                    kq, vq, ks, vs = copies[i % len(copies)]
                    return paged.paged_attention_quant_cuda(
                        q, kq, vq, ks, vs, bt, ln, kv_bits=kv_bits)
                cells.append(paged_cell(label, call, want))
        print(f"{name}: " + " | ".join(cells), flush=True)
    paged.quant_kernel = route
    return 0


if __name__ == "__main__":
    sys.exit(main())
