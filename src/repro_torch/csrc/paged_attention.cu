// paged_attention / paged_attention_quant: decode attention of one query
// token per slot over that slot's pages of a paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/paged_attention.py
// (paged_attention_pallas, and paged_attention_quant_pallas with its body
// _quant_kernel). Plain versions: repro_torch.kernels.paged_attention
// .paged_attention_plain / .paged_attention_quant_plain (the ports of
// kernels/ref.paged_attention_ref / paged_attention_quant_ref).
//
// Layout: q (B, H, hd) in f32 or bf16; pool (NB, BS, KV, row) with row =
// hd values (f32 or bf16 pages), hd int8 codes, or hd/2 bytes of 4-bit
// offset-binary nibble pairs (low nibble first, value = code - 8); one f32
// scale per (page, kv_head) in (NB, KV) for the quantized pools; block
// tables (B, MAXB) int32; lengths (B,) int32. Query head h reads KV head
// h / G, G = H / KV (qwen2: 7, not a power of two), or, with a head map
// (the int32 device table of kernels/headmap.py, [map (H) | rank (H) |
// offsets (KV + 1) | heads (H)]: the uneven map of a tensor-parallel
// plan), KV head map[h]: KV head kv's block then takes the heads[offsets
// [kv], offsets[kv + 1]) of its group, G being the largest group (at
// most 16), and the combine writes head h from row rank[h] of its group's
// partials. qwen2 at tp = 3 has 30 heads over 4, groups of 9, 7, 7, 7:
// every group still fits one 16-row mma fragment. The query sits at
// position length-1: keys at positions >= length are masked, and with
// window > 0 so are keys with (length-1) - pos >= window. A slot of
// length 0 writes exact zeros. Output (B, H, hd) in q's type.
//
// What bounds it on the H100: bytes. One query token per slot does
// 4·H·hd flops per key against 2·KV·hd·(bytes per value) bytes of K/V per
// key, 7 flop/byte in bf16 (qwen2: H/KV = 7) — far under the ~295 the
// card needs to be compute-bound. So the least time is the live pages'
// bytes over 3.35 TB/s: at B=8 and ~2k tokens per slot that is ~32 MB, ~10 us.
//
// Design (flash-decoding): the TPU walked a slot's pages as a sequential
// grid dimension with m/l/acc in VMEM scratch. Here one block takes one
// (split, kv head, slot): a split is a fixed range of pps logical pages
// (256 tokens at BS=16), so a long slot spreads over many SMs, and a
// second small kernel combines the splits' (m, l, acc). A block loads its
// own block-table entries and length, and loops over its live keys in
// tiles of 64: K/V rows are read with 16-byte loads where the row allows,
// unpacked to f32 in shared memory (codes are never written back to
// device memory dequantized), each thread scores (g, key) pairs, one warp
// per query head runs the online softmax, and each thread accumulates
// P·V for its head dims of all G heads in registers. The per-page K scale
// multiplies the score after the dot and the V scale multiplies the
// probability before P·V. Keys outside [max(0, length-window), length)
// are never loaded, and splits with no live key write only m = -inf.
// The split size does not depend on the batch, so a slot's result does
// not depend on its batchmates. The CUDA-core split kernel (f32 math)
// serves f32 q or pages, and f32 q or rows narrower than 4 bytes of codes
// over the int8 / 4-bit pools.
//
// bf16 q over bf16 pages (the main path) takes a tensor-core split kernel
// with the same splits, masks and combine: the G query rows of the KV head
// are zero-padded to the 16 rows of an mma A fragment (held in registers
// through ldmatrix; re-read per tile for hd > 128); K/V rows are gathered
// by block table into shared memory as bf16 through a 3-stage cp.async
// ring of 64-key tiles (16/8/4-byte copies, rows padded by 16 bytes for
// conflict-free ldmatrix, hd zero-padded to a multiple of 16), so ~64 KB
// a block are in flight at hd 128; each warp takes 16 keys of a tile,
// with S = Q.K^T by mma.m16n8k16 (bf16 in, f32 accumulate), its own
// online softmax (m, l, acc) in registers and P.V with P split into bf16
// hi + lo (two mmas, ~16 bits of P); the block merges its warps once, at
// the end of the split, in shared memory. To shorten each block's chain
// of dependent loads, it reads its split's block-table entries alongside
// the slot's length and issues the Q copy before the table is resolved.
//
// bf16 q over int8 / 4-bit pools takes the same design on tensor cores
// (the main path's serve at kv_bits 8 / 4): the ring copies the raw code
// rows (hd or hd/2 bytes, 16-byte copies; codes are never written to
// device memory dequantized) and the warps widen them to bf16 in
// registers by magic numbers, exactly (int8 -127..127, 4-bit -8..7), so
// S = Q.K^T by mma.m16n8k16 is the f32-accumulated product of exact
// operands. One 32-bit word of a code row feeds a lane's K fragment whole:
// Q's head dims are permuted to match when it is staged. The V fragment
// pairs one dim of two key rows straight from their words (byte_perm),
// and P.V's accumulator holds the dims in that word order until the merge.
// The K page scale multiplies each key's score with the softmax scale; l
// sums the unscaled P, and P.V sees P times each key's V page scale,
// split into bf16 hi + lo. Scales are read per key: a window may start
// mid-page. A page id out of range reads as a zero row with scale 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 64;     // keys per shared-memory tile (2 per lane)
constexpr int kMaxG = 16;   // query heads per KV head
constexpr int kMaxDPT = 2;  // head dims per thread: hd <= 256

static_assert(kTK == 64, "the softmax gives each lane two keys of a tile");
static_assert(kMaxDPT == 2, "the combine kernel holds two dims a thread");

enum Kind { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

template <int W> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<1> { using T = uint8_t; };

// values of a W-byte load
template <int KIND, int W> struct Unit {
  static constexpr int kValues = KIND == kF32 ? W / 4
                                 : KIND == kBF16 ? W / 2
                                 : KIND == kInt8 ? W : 2 * W;
};

template <int KIND, int W>
__device__ __forceinline__ void unpack(const uint8_t* b, float* dst) {
#pragma unroll
  for (int e = 0; e < Unit<KIND, W>::kValues; ++e) {
    if (KIND == kF32) {
      float f;
      memcpy(&f, b + 4 * e, 4);
      dst[e] = f;
    } else if (KIND == kBF16) {
      const uint32_t u = (uint32_t)b[2 * e] | ((uint32_t)b[2 * e + 1] << 8);
      dst[e] = __uint_as_float(u << 16);
    } else if (KIND == kInt8) {
      dst[e] = (float)(int8_t)b[e];
    } else {
      const uint8_t c = b[e / 2];
      dst[e] = (float)((e & 1) ? (c >> 4) : (c & 15)) - 8.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

struct Args {
  const void* q;
  const uint8_t* k;
  const uint8_t* v;
  const float* ks;  // (NB, KV) or null
  const float* vs;
  const int* bt;
  const int* lens;
  void* o;
  float* part_acc;  // (B, KV, NS, G, hd)
  float* part_ml;   // (B, KV, NS, G, 2)
  int q_bf16, B, H, KV, G, hd, NB, BS, MAXB, pps, NS, window, row_bytes;
  float scale;
  const int* hmap;  // the head-map table, or null for the even map
};

// the size of KV head kv's group, and the query head of its row r, from
// the head-map table (kMapped) or the even map. The tensor-core kernels
// take kMapped as a template argument, so their even-map instantiations
// hold no table code; the CUDA-core kernel tests a.hmap at run time.
template <bool kMapped>
__device__ __forceinline__ int group_rows(const Args& a, int kv) {
  if constexpr (kMapped)
    return a.hmap[2 * a.H + kv + 1] - a.hmap[2 * a.H + kv];
  return a.G;
}
template <bool kMapped>
__device__ __forceinline__ int group_head(const Args& a, int kv, int r) {
  if constexpr (kMapped)
    return a.hmap[2 * a.H + a.KV + 1 + a.hmap[2 * a.H + kv] + r];
  return kv * a.G + r;
}
// the heads of KV head kv's group, in row order (kMapped): read once a
// block, so that a loop over rows makes one load a row, not two dependent
__device__ __forceinline__ const int* group_heads(const Args& a, int kv) {
  return a.hmap + 2 * a.H + a.KV + 1 + a.hmap[2 * a.H + kv];
}

size_t split_smem_bytes(int G, int hd) {
  return sizeof(float) * ((size_t)G * hd + (size_t)kTK * (hd + 1) +
                          (size_t)kTK * hd + (size_t)G * kTK + 2 * kTK +
                          3 * (size_t)G);
}

template <int KIND, int W>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, GM = a.G;     // GM: the largest group (the layout's)
  float* qs = smem;                  // [GM][hd]
  float* ksm = qs + GM * hd;         // [kTK][hd+1] (odd stride: no conflicts)
  float* vsm = ksm + kTK * (hd + 1); // [kTK][hd]
  float* sc = vsm + kTK * hd;        // [GM][kTK] scores, then p·v_scale
  float* kscl = sc + GM * kTK;       // [kTK] softmax scale · K page scale
  float* vscl = kscl + kTK;          // [kTK] V page scale
  float* m_s = vscl + kTK;           // [GM]
  float* l_s = m_s + GM;             // [GM]
  float* corr_s = l_s + GM;          // [GM]

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool mapped = a.hmap != nullptr;
  // this KV head's query heads
  const int G = mapped ? group_rows<true>(a, kv) : group_rows<false>(a, kv);
  const int len = min(a.lens[b], a.MAXB * a.BS);  // the table's extent
  const int k_lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int span = a.pps * a.BS;
  const int s_lo = max(k_lo, split * span);
  const int s_hi = min(len, (split + 1) * span);
  const size_t part = ((size_t)(b * a.KV + kv) * a.NS + split) * a.G;
  if (s_lo >= s_hi) {  // no live key in this split
    if (tid < G) {
      a.part_ml[2 * (part + tid)] = -INFINITY;
      a.part_ml[2 * (part + tid) + 1] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const size_t qi =
        ((size_t)b * a.H + (mapped ? group_head<true>(a, kv, i / hd)
                                   : group_head<false>(a, kv, i / hd))) *
            hd +
        i % hd;
    qs[i] = a.q_bf16
                ? __bfloat162float(((const __nv_bfloat16*)a.q)[qi])
                : ((const float*)a.q)[qi];
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kMaxDPT];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int s = 0; s < kMaxDPT; ++s) acc[g][s] = 0.f;

  using VT = typename Vec<W>::T;
  constexpr int EPU = Unit<KIND, W>::kValues;
  const int units = a.row_bytes / W;
  const bool quant = a.ks != nullptr;

  for (int t0 = s_lo; t0 < s_hi; t0 += kTK) {
    const int n = min(kTK, s_hi - t0);
    __syncthreads();  // previous tile consumed; q and m/l staged
    for (int i = tid; i < kTK * units; i += kThreads) {
      const int j = i / units, u = i % units;
      float* kd = ksm + j * (hd + 1) + u * EPU;
      float* vd = vsm + j * hd + u * EPU;
      int page = -1, off = 0;
      if (j < n) {
        const int kpos = t0 + j;
        page = a.bt[(size_t)b * a.MAXB + kpos / a.BS];
        off = kpos % a.BS;
      }
      if (page >= 0 && page < a.NB) {
        const size_t row =
            ((size_t)(page * a.BS + off) * a.KV + kv) * a.row_bytes +
            (size_t)u * W;
        const VT kr = *reinterpret_cast<const VT*>(a.k + row);
        const VT vr = *reinterpret_cast<const VT*>(a.v + row);
        unpack<KIND, W>(reinterpret_cast<const uint8_t*>(&kr), kd);
        unpack<KIND, W>(reinterpret_cast<const uint8_t*>(&vr), vd);
      } else {  // past the tile's live keys (or a page id out of range)
#pragma unroll
        for (int e = 0; e < EPU; ++e) {
          kd[e] = 0.f;
          vd[e] = 0.f;
        }
      }
    }
    for (int j = tid; j < kTK; j += kThreads) {
      float kf = 0.f, vf = 0.f;
      if (j < n) {
        kf = a.scale;
        vf = 1.f;
        if (quant) {
          const int page = a.bt[(size_t)b * a.MAXB + (t0 + j) / a.BS];
          if (page >= 0 && page < a.NB) {
            kf *= a.ks[(size_t)page * a.KV + kv];
            vf = a.vs[(size_t)page * a.KV + kv];
          }
        }
      }
      kscl[j] = kf;
      vscl[j] = vf;
    }
    __syncthreads();

    for (int i = tid; i < G * kTK; i += kThreads) {
      const int g = i / kTK, j = i % kTK;
      float s = -INFINITY;
      if (j < n) {
        const float* qr = qs + g * hd;
        const float* kr = ksm + j * (hd + 1);
        float d0 = 0.f, d1 = 0.f;
        int d = 0;
        for (; d + 1 < hd; d += 2) {
          d0 = fmaf(qr[d], kr[d], d0);
          d1 = fmaf(qr[d + 1], kr[d + 1], d1);
        }
        if (d < hd) d0 = fmaf(qr[d], kr[d], d0);
        s = (d0 + d1) * kscl[j];
      }
      sc[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * kTK;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float tmax = warp_max(fmaxf(s0, s1));
      const float m_old = m_s[g];
      float m_new = m_old, corr = 1.f, p0 = 0.f, p1 = 0.f;
      if (tmax != -INFINITY) {
        m_new = fmaxf(m_old, tmax);
        corr = expf(m_old - m_new);
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
      }
      const float psum = warp_sum(p0 + p1);
      row[lane] = p0 * vscl[lane];
      row[lane + 32] = p1 * vscl[lane + 32];
      if (lane == 0) {
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int ds = 0; ds < kMaxDPT; ++ds) {
      const int d = tid + ds * kThreads;
      if (d >= hd) continue;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g][ds] *= corr_s[g];
      for (int j = 0; j < n; ++j) {
        const float vv = vsm[j * hd + d];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][ds] = fmaf(sc[g * kTK + j], vv, acc[g][ds]);
      }
    }
  }

#pragma unroll
  for (int ds = 0; ds < kMaxDPT; ++ds) {
    const int d = tid + ds * kThreads;
    if (d >= hd) continue;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) a.part_acc[(part + g) * hd + d] = acc[g][ds];
  }
  if (tid < G) {
    a.part_ml[2 * (part + tid)] = m_s[tid];
    a.part_ml[2 * (part + tid) + 1] = l_s[tid];
  }
}

// One block per (query head, slot): merge the splits' (m, l, acc); with a
// head map (kMapped) head h's partials are row rank[h] of KV head map[h]'s
// group. The splits' (m, l) are staged in shared memory by parallel loads,
// so only the acc loads stay in the loop (unrolled, issued ahead of their
// use).
template <bool kMapped>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const Args a) {
  extern __shared__ float ml_sh[];  // [NS][2]
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int kv = kMapped ? a.hmap[h] : h / a.G;
  const int g = kMapped ? a.hmap[a.H + h] : h % a.G;
  const size_t base = (size_t)(b * a.KV + kv) * a.NS * a.G + g;
  for (int s = tid; s < a.NS; s += kThreads) {
    const size_t p = base + (size_t)s * a.G;
    ml_sh[2 * s] = a.part_ml[2 * p];
    ml_sh[2 * s + 1] = a.part_ml[2 * p + 1];
  }
  __syncthreads();
  float M = -INFINITY;
  for (int s = 0; s < a.NS; ++s) M = fmaxf(M, ml_sh[2 * s]);
  float out[kMaxDPT] = {0.f, 0.f};
  if (M != -INFINITY) {
    float L = 0.f;
#pragma unroll 16
    for (int s = 0; s < a.NS; ++s) {
      const size_t p = base + (size_t)s * a.G;
      const float m = ml_sh[2 * s];
      const float w = expf(m - M);
      float x[kMaxDPT];  // predicated loads, issued ahead of their use
#pragma unroll
      for (int ds = 0; ds < kMaxDPT; ++ds) {
        const int d = tid + ds * kThreads;
        x[ds] = d < a.hd && m != -INFINITY ? a.part_acc[p * a.hd + d] : 0.f;
      }
      if (m == -INFINITY) continue;
      L += w * ml_sh[2 * s + 1];
#pragma unroll
      for (int ds = 0; ds < kMaxDPT; ++ds) out[ds] = fmaf(w, x[ds], out[ds]);
    }
    const float inv = 1.f / fmaxf(L, 1e-20f);
#pragma unroll
    for (int ds = 0; ds < kMaxDPT; ++ds) out[ds] *= inv;
  }
#pragma unroll
  for (int ds = 0; ds < kMaxDPT; ++ds) {
    const int d = tid + ds * kThreads;
    if (d >= a.hd) continue;
    const size_t oi = ((size_t)b * a.H + h) * a.hd + d;
    if (a.q_bf16) {
      ((__nv_bfloat16*)a.o)[oi] = __float2bfloat16_rn(out[ds]);
    } else {
      ((float*)a.o)[oi] = out[ds];
    }
  }
}

template <bool kMapped>
int launch_combine_map(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * a.NS;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_combine_kernel<kMapped>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_combine_kernel<kMapped>
      <<<dim3(a.H, a.B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_combine(const Args& a, cudaStream_t stream) {
  return a.hmap != nullptr ? launch_combine_map<true>(a, stream)
                           : launch_combine_map<false>(a, stream);
}

// ---------------------------------------------------------------------------
// bf16 q over bf16 pages: tensor cores (mma.sync m16n8k16) fed by a
// 3-stage cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTcStages = 3;
constexpr int kMaxSpan = 512;  // tokens a split (pps * BS) the kernel takes
constexpr int kRowPad = 8;  // bf16 elements (16 bytes) added to each row
constexpr float kLn2 = 0.69314718055994531f;

using bf16 = __nv_bfloat16;

// The end of a split on tensor cores: merge the warps' (m, l, acc), each
// over its own keys ((m, l) per row, then the accumulators rescaled to the
// rows' common max and summed) and write the split's partials. pos_of(d)
// is where head dim d sits in the accumulator: column 8 * tile + c of its
// 2 KD 8-column tiles. o_s ([kWarps][16][16 KD + 8] f32: the row pad makes
// the fragment's float2 stores conflict-free) may alias the K/V stages
// once every warp is done with them; ml_s is [kWarps][16][2].
template <int KD, class PosOf>
__device__ __forceinline__ void merge_warps(const Args& a,
                                            const float (&acc)[2 * KD][4],
                                            const float (&m)[2],
                                            const float (&l)[2], float* o_s,
                                            float* ml_s, size_t part, int G,
                                            int tid, PosOf pos_of) {
  using namespace mma_bf16;
  constexpr int OLD = 16 * KD + 8;
  const int lane = tid & 31, warp = tid >> 5, gid = lane >> 2, tig = lane & 3;
  const int hd = a.hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (tig == 0) {
      ml_s[2 * (warp * 16 + gid + 8 * r)] = m[r];
      ml_s[2 * (warp * 16 + gid + 8 * r) + 1] = lr;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gid + 8 * r;
    float mx = -INFINITY;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      mx = fmaxf(mx, ml_s[2 * (ww * 16 + row)]);
    const float wgt = mx == -INFINITY ? 0.f : exp2f(m[r] - mx);
    float* dst = o_s + (warp * 16 + row) * OLD + 2 * tig;
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t)
      *reinterpret_cast<float2*>(dst + 8 * t) =
          make_float2(acc[t][2 * r] * wgt, acc[t][2 * r + 1] * wgt);
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd, pd = pos_of(d);
    float sum = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) sum += o_s[(ww * 16 + g) * OLD + pd];
    a.part_acc[(part + g) * hd + d] = sum;
  }
  if (tid < G) {
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      mx = fmaxf(mx, ml_s[2 * (ww * 16 + tid)]);
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float mw = ml_s[2 * (ww * 16 + tid)];
      if (mw != -INFINITY)
        sum += exp2f(mw - mx) * ml_s[2 * (ww * 16 + tid) + 1];
    }
    a.part_ml[2 * (part + tid)] = mx * kLn2;  // natural units, as the f32 path
    a.part_ml[2 * (part + tid) + 1] = sum;
  }
}

// KD: 16-wide steps of the zero-padded head dim (HD = 16 * KD >= hd);
// w: the cp.async width in bytes (16, 8 or 4).
template <int KD, bool kMapped>
__global__ void __launch_bounds__(kThreads)
    paged_split_tc_kernel(const Args a, int w) {
  using namespace mma_bf16;
  constexpr int HD = 16 * KD;
  constexpr int LD = HD + kRowPad;  // row stride (elements): 16 B odd
  constexpr int LDB = 2 * LD;
  constexpr bool kQInRegs = KD <= 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K rows [0, kTK), then V rows [kTK, 2 kTK), each LD wide
  bf16* kv_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = kv_s + kTcStages * 2 * kTK * LD;              // [16][LD]
  float* ml_s = reinterpret_cast<float*>(qs + 16 * LD);    // [kWarps][16][2]
  int* rows_s = reinterpret_cast<int*>(ml_s + kWarps * 16 * 2);  // [span]
  float* o_s = reinterpret_cast<float*>(smem_raw);  // after the loop

  const int hd = a.hd;
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = group_rows<kMapped>(a, kv);  // this KV head's query heads
  const int span = a.pps * a.BS;
  // the block-table entries of this thread's keys split * span + j, j =
  // tid, tid + 128, ... (at most kMaxSpan / kThreads), loaded alongside
  // the slot's length rather than after it
  constexpr int kKeysPerThread = kMaxSpan / kThreads;
  const int* bt = a.bt + (size_t)b * a.MAXB;
  int page[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int j = tid + i * kThreads;
    const int pi = (split * span + j) / a.BS;
    page[i] = j < span && pi < a.MAXB ? bt[pi] : -1;
  }
  const int len = min(a.lens[b], a.MAXB * a.BS);  // the table's extent
  const int k_lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int s_lo = max(k_lo, split * span);
  const int s_hi = min(len, (split + 1) * span);
  const size_t part = ((size_t)(b * a.KV + kv) * a.NS + split) * a.G;
  if (s_lo >= s_hi) {  // no live key in this split
    if (tid < G) {
      a.part_ml[2 * (part + tid)] = -INFINITY;
      a.part_ml[2 * (part + tid) + 1] = 0.f;
    }
    return;
  }

  // pad columns [hd, HD) of the K/V and Q rows (contiguous): cp.async
  // writes only [0, hd)
  for (int i = tid; i < (kTcStages * 2 * kTK + 16) * (HD - hd) / 2;
       i += kThreads) {
    const int r = i / ((HD - hd) / 2), c = hd + 2 * (i % ((HD - hd) / 2));
    *reinterpret_cast<uint32_t*>(kv_s + r * LD + c) = 0u;
  }

  const int cpr = a.row_bytes / w;  // cp.async chunks per row

  // the group's G query rows, zero-filled to the 16 rows of an A fragment,
  // in the first group with tile 0 (issued first: it needs no block table)
  if constexpr (kMapped) {
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(a.q) +
                        (size_t)b * a.H * a.row_bytes;
    const int* heads = group_heads(a, kv);
    for_each_chunk(16, cpr, tid, kThreads, [&](int r, int c) {
      cp_async_w(smem_u32(reinterpret_cast<char*>(qs + r * LD) + c * w),
                 qb + (r < G ? (size_t)heads[r] * a.row_bytes + c * w : 0),
                 r < G, w);
    });
  } else {
    const uint8_t* qg = reinterpret_cast<const uint8_t*>(a.q) +
                        ((size_t)b * a.H + kv * G) * a.row_bytes;
    for_each_chunk(16, cpr, tid, kThreads, [&](int r, int c) {
      cp_async_w(smem_u32(reinterpret_cast<char*>(qs + r * LD) + c * w),
                 qg + (r < G ? (size_t)r * a.row_bytes + c * w : 0), r < G,
                 w);
    });
  }

  // the pool row (page * BS + offset) * KV + kv of each key of the split
  // (indexed from split * span); -1 for a page id out of range (a zero
  // row, as the CUDA-core path reads it)
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int j = tid + i * kThreads, kpos = split * span + j;
    if (j < span)
      rows_s[j] = page[i] >= 0 && page[i] < a.NB
                      ? (page[i] * a.BS + kpos % a.BS) * a.KV + kv
                      : -1;
  }
  __syncthreads();

  // keys [t0, t0 + kTK) of the split into `stage` (rows r: K rows, then
  // V rows); keys past s_hi are zero-filled
  auto load_tile = [&](int stage, int t0) {
    bf16* dst = kv_s + stage * 2 * kTK * LD;
    const int n = min(kTK, s_hi - t0);
    const int* rows = rows_s + (t0 - split * span);
    for_each_chunk(2 * kTK, cpr, tid, kThreads, [&](int r, int c) {
      const int j = r < kTK ? r : r - kTK;
      const int row = j < n ? rows[j] : -1;
      const uint8_t* src = (r < kTK ? a.k : a.v) +
                           (row >= 0 ? (size_t)row * a.row_bytes + c * w : 0);
      cp_async_w(smem_u32(reinterpret_cast<char*>(dst + r * LD) + c * w),
                 src, row >= 0, w);
    });
  };

  const int n_tiles = (s_hi - s_lo + kTK - 1) / kTK;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, s_lo + st * kTK);
    cp_async_commit();
  }

  const int gid = lane >> 2, tig = lane & 3;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const uint32_t q_lane = lane_addr_a(smem_u32(qs), LDB, lane);
  uint32_t qf[kQInRegs ? KD : 1][4];
  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kTcStages - 2>();  // tile `it` has landed
    __syncthreads();  // ... for every thread; stage (it - 1) % 3 is free
    if (it + kTcStages - 1 < n_tiles)
      load_tile((it + kTcStages - 1) % kTcStages,
                s_lo + (it + kTcStages - 1) * kTK);
    cp_async_commit();
    if (kQInRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? KD : 1); ++kk)
        ldmatrix_x4(qf[kk], q_lane + 32 * kk);
    }
    const int n = min(kTK, s_hi - (s_lo + it * kTK));
    if (16 * warp >= n) continue;  // this warp's 16 keys are all past s_hi

    const bf16* k_w = kv_s + (it % kTcStages) * 2 * kTK * LD + 16 * warp * LD;
    const uint32_t k_lane = lane_addr_b(smem_u32(k_w), LDB, lane);
    const uint32_t v_lane = lane_addr_a(smem_u32(k_w + kTK * LD), LDB, lane);

    // S = Q K^T: the 16 (padded) query rows x this warp's 16 keys
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    uint32_t bk[2][4];  // K fragments one step ahead of the mmas
    ldmatrix_x4(bk[0], k_lane);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk + 1 < KD) ldmatrix_x4(bk[(kk + 1) & 1], k_lane + 32 * (kk + 1));
      uint32_t q_a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) q_a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(q_a, q_lane + 32 * kk);
      }
      mma_16816(s[0], q_a, bk[kk & 1][0], bk[kk & 1][1]);
      mma_16816(s[1], q_a, bk[kk & 1][2], bk[kk & 1][3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * warp + 8 * t + 2 * tig + (e & 1);
        s[t][e] = j < n ? s[t][e] * scale_log2 : -INFINITY;
      }

    float corr[2];
    online_softmax<2>(s, m, l, corr);
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }
    pv_split<KD>(acc, s[0], s[1], v_lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: o_s reuses them

  merge_warps<KD>(a, acc, m, l, o_s, ml_s, part, G, tid,
                  [](int d) { return d; });
}

template <int KD, bool kMapped>
int launch_tc_map(const Args& a, int w, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (16 * KD + kRowPad) *
                          (kTcStages * 2 * kTK + 16) +
                      sizeof(float) * kWarps * 16 * 2 +
                      sizeof(int) * a.pps * a.BS;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_tc_kernel<KD, kMapped>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_split_tc_kernel<KD, kMapped>
      <<<dim3(a.NS, a.KV, a.B), kThreads, smem, stream>>>(a, w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_combine(a, stream);
}

template <int KD>
int launch_tc(const Args& a, int w, cudaStream_t stream) {
  return a.hmap != nullptr ? launch_tc_map<KD, true>(a, w, stream)
                           : launch_tc_map<KD, false>(a, w, stream);
}

// bf16 q over bf16 pages: the widest cp.async (16, 8 or 4 bytes) that
// divides the row bytes and the alignment of q and the pools, then the
// head-dim steps
int launch_bf16(const Args& a, cudaStream_t stream) {
  const uintptr_t al = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                       (uintptr_t)a.row_bytes;
  const int w = al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : al % 4 == 0 ? 4 : 0;
  if (w == 0) return (int)cudaErrorMisalignedAddress;
  if (a.pps * a.BS > kMaxSpan) return (int)cudaErrorInvalidValue;
  const int steps = (a.hd + 15) / 16;
  if (steps <= 1) return launch_tc<1>(a, w, stream);
  if (steps <= 2) return launch_tc<2>(a, w, stream);
  if (steps <= 4) return launch_tc<4>(a, w, stream);
  if (steps <= 8) return launch_tc<8>(a, w, stream);
  return launch_tc<16>(a, w, stream);
}

// ---------------------------------------------------------------------------
// bf16 q over int8 / 4-bit pools: the bf16 kernel's splits, ring, softmax
// and merge on tensor cores, with the raw codes in the ring and widened to
// bf16 in registers
// ---------------------------------------------------------------------------

constexpr int kQuantStages = 3;
constexpr int kCodePad = 16;  // bytes added to each code row (conflict-free)

// Codes widen to bf16 exactly by magic numbers, as in quant_matmul.cu.
// int8 code c of byte b of u = w ^ 0x80808080: the f32 with bits
// 0x4B0000uu is 2^23 + 128 + c, so less 2^23 + 128 it is c (exact). (A
// bf16-only widening, 0x4300 | (c & 127) less 0x4300 | (c & 128) by
// __hsub2, issues fewer instructions but ran slower on the H100.)
__device__ __forceinline__ float int8_f32(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | b)) -
         8388736.f;
}
// two small integers held exactly in f32 -> a bf16 pair (x0 low): the top
// 16 bits of each, exact since they have at most 8 significant bits
__device__ __forceinline__ uint32_t bf16_pair(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}
// 4-bit offset-binary nibbles u at bits 0-3 and 16-19 of t -> the bf16
// pair (u0 - 8, u1 - 8): 0x4300 | u is bf16 128 + u, less 136 (exact)
__device__ __forceinline__ uint32_t nib_pair(uint32_t t) {
  const uint32_t x = (t & 0x000F000Fu) | 0x43004300u;
  const uint32_t c136 = 0x43084308u;
  return mma_bf16::bits_of(
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
              *reinterpret_cast<const __nv_bfloat162*>(&c136)));
}

// The head dim at position pos of the zero-padded Q row (the A fragment's
// column 16 kk + p) and so of the K fragments: one 32-bit word of a key row
// feeds a lane's K fragment registers whole. int8: lane tig of step kk
// reads the codes of dims 16 kk + 4 tig .. + 3, b0 = (+0, +1), b1 = (+2,
// +3). 4-bit: lane tig reads the word of dims 32 (kk / 2) + 8 tig .. + 7
// (nibble j = dim j), and the register (w >> 4 s) & 0x000F000F pairs dims
// (s, s + 4): steps 2 kk' / 2 kk' + 1 take s = 0, 1 / 2, 3.
template <int KIND>
__device__ __forceinline__ int q_dim(int pos) {
  const int kk = pos >> 4, p = pos & 15, r = p >> 3, tig = (p & 7) >> 1,
            e = p & 1;
  return KIND == kInt8 ? 16 * kk + 4 * tig + 2 * r + e
                       : 32 * (kk >> 1) + 8 * tig + 2 * (kk & 1) + r + 4 * e;
}

// Where head dim d sits in P.V's accumulator (8 * tile + column). The V
// fragment of column n of tile VPW * g + i is built from the 32-bit words
// at byte 32 g + 4 n of four key rows (VPW codes a word, value i of it),
// so tile VPW * g + i column n is dim 8 VPW g + VPW n + i.
template <int KIND>
__device__ __forceinline__ int acc_pos(int d) {
  constexpr int VPW = KIND == kInt8 ? 4 : 8;
  const int g = d / (8 * VPW), n = (d / VPW) % 8, i = d % VPW;
  return 8 * (VPW * g + i) + n;
}

template <int KD, int KIND>
constexpr size_t tcq_smem_bytes(int span) {
  constexpr size_t HD = 16 * KD, CB = KIND == kInt8 ? HD : HD / 2;
  constexpr size_t ring = (size_t)kQuantStages * 2 * kTK * (CB + kCodePad);
  constexpr size_t o_s = sizeof(float) * kWarps * 16 * (HD + 8);
  return (ring > o_s ? ring : o_s) + sizeof(bf16) * 16 * (HD + kRowPad) +
         sizeof(float) * kWarps * 16 * 2 +
         (2 * sizeof(float) + sizeof(int)) * (size_t)span;
}

// KD: 16-wide steps of the zero-padded head dim (HD = 16 * KD >= hd; a
// multiple of 32 for int8 and of 64 for 4-bit, the words' reach); KIND:
// kInt8 or kInt4; w: the cp.async width in bytes (16, 8 or 4).
template <int KD, int KIND, bool kMapped>
__global__ void __launch_bounds__(kThreads)
    paged_split_tcq_kernel(const Args a, int w) {
  using namespace mma_bf16;
  constexpr int HD = 16 * KD;
  constexpr int CB = KIND == kInt8 ? HD : HD / 2;  // code bytes a padded row
  constexpr int RS = CB + kCodePad;                // their stride in smem
  constexpr int LD = HD + kRowPad;                 // Q row stride
  constexpr int VPW = KIND == kInt8 ? 4 : 8;       // codes a 32-bit word
  constexpr bool kQInRegs = KD <= 8;
  static_assert(HD % (8 * VPW) == 0, "V words reach 8 VPW dims a tile group");
  constexpr size_t kRing = (size_t)kQuantStages * 2 * kTK * RS;
  constexpr size_t kOs = sizeof(float) * kWarps * 16 * (HD + 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K code rows [0, kTK), then V code rows [kTK, 2 kTK), RS apart
  uint8_t* ring = smem_raw;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + (kRing > kOs ? kRing : kOs));
  float* ml_s = reinterpret_cast<float*>(qs + 16 * LD);  // [kWarps][16][2]
  float* kscl = ml_s + kWarps * 16 * 2;  // [span] softmax scale * log2e * ks
  float* vscl = kscl + a.pps * a.BS;     // [span] vs
  int* rows_s = reinterpret_cast<int*>(vscl + a.pps * a.BS);  // [span]
  float* o_s = reinterpret_cast<float*>(smem_raw);  // after the loop

  const int hd = a.hd;
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = group_rows<kMapped>(a, kv);  // this KV head's query heads
  const int span = a.pps * a.BS;
  constexpr int kKeysPerThread = kMaxSpan / kThreads;
  const int* bt = a.bt + (size_t)b * a.MAXB;
  int page[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int j = tid + i * kThreads;
    const int pi = (split * span + j) / a.BS;
    page[i] = j < span && pi < a.MAXB ? bt[pi] : -1;
  }
  const int len = min(a.lens[b], a.MAXB * a.BS);  // the table's extent
  const int k_lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int s_lo = max(k_lo, split * span);
  const int s_hi = min(len, (split + 1) * span);
  const size_t part = ((size_t)(b * a.KV + kv) * a.NS + split) * a.G;
  if (s_lo >= s_hi) {  // no live key in this split
    if (tid < G) {
      a.part_ml[2 * (part + tid)] = -INFINITY;
      a.part_ml[2 * (part + tid) + 1] = 0.f;
    }
    return;
  }

  // the group's G query rows in q_dim order, zero-filled to the 16 rows
  // of an A fragment and past hd (plain loads: issued before the table is
  // resolved)
  if constexpr (kMapped) {
    const bf16* qb =
        reinterpret_cast<const bf16*>(a.q) + (size_t)b * a.H * hd;
    const int* heads = group_heads(a, kv);
    for (int i = tid; i < 16 * HD; i += kThreads) {
      const int r = i / HD, pos = i % HD, d = q_dim<KIND>(pos);
      qs[r * LD + pos] = r < G && d < hd ? qb[(size_t)heads[r] * hd + d]
                                         : __float2bfloat16_rn(0.f);
    }
  } else {
    const bf16* qg =
        reinterpret_cast<const bf16*>(a.q) + ((size_t)b * a.H + kv * G) * hd;
    for (int i = tid; i < 16 * HD; i += kThreads) {
      const int r = i / HD, pos = i % HD, d = q_dim<KIND>(pos);
      qs[r * LD + pos] =
          r < G && d < hd ? qg[r * hd + d] : __float2bfloat16_rn(0.f);
    }
  }
  // the pool row of each key of the split (from split * span); -1 for a
  // page id out of range (a zero row with scale 0)
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int j = tid + i * kThreads, kpos = split * span + j;
    if (j < span)
      rows_s[j] = page[i] >= 0 && page[i] < a.NB
                      ? (page[i] * a.BS + kpos % a.BS) * a.KV + kv
                      : -1;
  }
  __syncthreads();

  const int cpr = a.row_bytes / w;  // cp.async chunks per row
  // keys [t0, t0 + kTK) of the split into `stage`; keys past s_hi are
  // zero-filled
  auto load_tile = [&](int stage, int t0) {
    uint8_t* dst = ring + stage * 2 * kTK * RS;
    const int n = min(kTK, s_hi - t0);
    const int* rows = rows_s + (t0 - split * span);
    for_each_chunk(2 * kTK, cpr, tid, kThreads, [&](int r, int c) {
      const int j = r < kTK ? r : r - kTK;
      const int row = j < n ? rows[j] : -1;
      const uint8_t* src = (r < kTK ? a.k : a.v) +
                           (row >= 0 ? (size_t)row * a.row_bytes + c * w : 0);
      cp_async_w(smem_u32(dst + r * RS + c * w), src, row >= 0, w);
    });
  };

  const int n_tiles = (s_hi - s_lo + kTK - 1) / kTK;
#pragma unroll
  for (int st = 0; st < kQuantStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, s_lo + st * kTK);
    cp_async_commit();
  }

  // the keys' page scales, per key (a window may start mid-page), loaded
  // while the first tiles are in flight; published by the loop's barrier
  const float scale_log2 = a.scale * 1.4426950408889634f;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int j = tid + i * kThreads;
    if (j < span) {
      const bool ok = page[i] >= 0 && page[i] < a.NB;
      const size_t si = ok ? (size_t)page[i] * a.KV + kv : 0;
      kscl[j] = ok ? scale_log2 * a.ks[si] : 0.f;
      vscl[j] = ok ? a.vs[si] : 0.f;
    }
  }

  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t q_lane = lane_addr_a(smem_u32(qs), 2 * LD, lane);
  uint32_t qf[kQInRegs ? KD : 1][4];
  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kQuantStages - 2>();  // tile `it` has landed
    __syncthreads();  // ... for every thread; stage (it - 1) % S is free
    if (it + kQuantStages - 1 < n_tiles)
      load_tile((it + kQuantStages - 1) % kQuantStages,
                s_lo + (it + kQuantStages - 1) * kTK);
    cp_async_commit();
    if (kQInRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? KD : 1); ++kk)
        ldmatrix_x4(qf[kk], q_lane + 32 * kk);
    }
    const int t0 = s_lo + it * kTK;
    const int n = min(kTK, s_hi - t0);
    if (16 * warp >= n) continue;  // this warp's 16 keys are all past s_hi

    const uint8_t* k_w = ring + (it % kQuantStages) * 2 * kTK * RS +
                         16 * warp * RS;
    const uint8_t* v_w = k_w + kTK * RS;
    const int jt = t0 - split * span;  // kscl / vscl index of the tile

    auto q_frag = [&](int kk, uint32_t (&q_a)[4]) {
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) q_a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(q_a, q_lane + 32 * kk);
      }
    };

    // S = Q K^T over exact codes: the 16 (padded) query rows x the warp's
    // 16 keys (tile t: keys 8 t + gid as B columns)
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    if constexpr (KIND == kInt8) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t q_a[4];
        q_frag(kk, q_a);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
                                 k_w + (8 * t + gid) * RS + 16 * kk + 4 * tig) ^
                             0x80808080u;
          mma_16816(s[t], q_a, bf16_pair(int8_f32(u, 0), int8_f32(u, 1)),
                    bf16_pair(int8_f32(u, 2), int8_f32(u, 3)));
        }
      }
    } else {
#pragma unroll
      for (int k2 = 0; k2 < KD / 2; ++k2) {
        uint32_t wd[2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
          wd[t] = *reinterpret_cast<const uint32_t*>(
              k_w + (8 * t + gid) * RS + 16 * k2 + 4 * tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t q_a[4];
          q_frag(2 * k2 + h, q_a);
#pragma unroll
          for (int t = 0; t < 2; ++t)
            mma_16816(s[t], q_a, nib_pair(wd[t] >> (8 * h)),
                      nib_pair(wd[t] >> (8 * h + 4)));
        }
      }
    }
    // the softmax scale and the K page scale, per key
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * warp + 8 * t + 2 * tig + (e & 1);
        s[t][e] = j < n ? s[t][e] * kscl[jt + j] : -INFINITY;
      }

    float corr[2];
    online_softmax<2>(s, m, l, corr);  // l sums the unscaled P
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }
    // P . V sees P * vs (the V page scale, per key)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * warp + 8 * t + 2 * tig + (e & 1);
        s[t][e] = j < n ? s[t][e] * vscl[jt + j] : 0.f;
      }

    // P split into bf16 hi + lo as the A fragment; the V fragments pair
    // one dim of two key rows (2 tig + {0, 1}, 2 tig + 8 + {0, 1})
    // straight from the code words (tools/attention_ab.py times the other
    // design, a per-warp bf16 V tile read by ldmatrix)
    uint32_t hi[4], lo[4];
    split_pack(s[0][0], s[0][1], hi[0], lo[0]);
    split_pack(s[0][2], s[0][3], hi[1], lo[1]);
    split_pack(s[1][0], s[1][1], hi[2], lo[2]);
    split_pack(s[1][2], s[1][3], hi[3], lo[3]);
#pragma unroll
    for (int g = 0; g < HD / (8 * VPW); ++g) {
      uint32_t wv[4];  // key rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[r] = *reinterpret_cast<const uint32_t*>(
            v_w + (2 * tig + (r & 1) + 8 * (r >> 1)) * RS + 32 * g +
            4 * gid);
      uint32_t b0[VPW], b1[VPW];
      if constexpr (KIND == kInt8) {
        uint32_t u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = wv[r] ^ 0x80808080u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b0[i] = bf16_pair(int8_f32(u[0], i), int8_f32(u[1], i));
          b1[i] = bf16_pair(int8_f32(u[2], i), int8_f32(u[3], i));
        }
      } else {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const uint32_t x0 = __byte_perm(wv[0], wv[1], bb | ((4 + bb) << 8));
          const uint32_t x1 = __byte_perm(wv[2], wv[3], bb | ((4 + bb) << 8));
          b0[2 * bb] = nib_pair(x0);
          b1[2 * bb] = nib_pair(x1);
          b0[2 * bb + 1] = nib_pair(x0 >> 4);
          b1[2 * bb + 1] = nib_pair(x1 >> 4);
        }
      }
      // the hi mmas of all VPW tiles, then the lo ones: no two mmas into
      // one accumulator back to back
#pragma unroll
      for (int i = 0; i < VPW; ++i)
        mma_16816(acc[VPW * g + i], hi, b0[i], b1[i]);
#pragma unroll
      for (int i = 0; i < VPW; ++i)
        mma_16816(acc[VPW * g + i], lo, b0[i], b1[i]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: o_s reuses them
  merge_warps<KD>(a, acc, m, l, o_s, ml_s, part, G, tid,
                  [](int d) { return acc_pos<KIND>(d); });
}

template <int KD, int KIND, bool kMapped>
int launch_tcq_map(const Args& a, int w, cudaStream_t stream) {
  const size_t smem = tcq_smem_bytes<KD, KIND>(a.pps * a.BS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_tcq_kernel<KD, KIND, kMapped>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_split_tcq_kernel<KD, KIND, kMapped>
      <<<dim3(a.NS, a.KV, a.B), kThreads, smem, stream>>>(a, w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_combine(a, stream);
}

template <int KD, int KIND>
int launch_tcq(const Args& a, int w, cudaStream_t stream) {
  return a.hmap != nullptr ? launch_tcq_map<KD, KIND, true>(a, w, stream)
                           : launch_tcq_map<KD, KIND, false>(a, w, stream);
}

// bf16 q over int8 (hd % 4 == 0) or 4-bit (hd % 8 == 0) codes: rows copied
// in 4-byte units or wider, then the head-dim steps (a multiple of 2 for
// int8, of 4 for 4-bit)
int launch_quant_tc(const Args& a, int kind, cudaStream_t stream) {
  const uintptr_t al = (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.row_bytes;
  const int w = al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : al % 4 == 0 ? 4 : 0;
  if (w == 0) return (int)cudaErrorMisalignedAddress;
  if (!a.q_bf16 || a.pps * a.BS > kMaxSpan || a.hd % (kind == kInt8 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  const int steps = (a.hd + 15) / 16;
  if (kind == kInt8) {
    if (steps <= 2) return launch_tcq<2, kInt8>(a, w, stream);
    if (steps <= 4) return launch_tcq<4, kInt8>(a, w, stream);
    if (steps <= 8) return launch_tcq<8, kInt8>(a, w, stream);
    return launch_tcq<16, kInt8>(a, w, stream);
  }
  if (steps <= 4) return launch_tcq<4, kInt4>(a, w, stream);
  if (steps <= 8) return launch_tcq<8, kInt4>(a, w, stream);
  return launch_tcq<16, kInt4>(a, w, stream);
}

template <int KIND, int W>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(a.G, a.hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<KIND, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_split_kernel<KIND, W>
      <<<dim3(a.NS, a.KV, a.B), kThreads, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_combine(a, stream);
}

template <int KIND>
int launch_kind(const Args& a, cudaStream_t stream) {
  // the widest load that divides the row bytes and the pools' alignment
  // (every row starts at a multiple of row_bytes from the pool's base)
  const uintptr_t al = (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.row_bytes;
  if (al % 16 == 0) return launch<KIND, 16>(a, stream);
  if (al % 4 == 0) return launch<KIND, 4>(a, stream);
  if constexpr (KIND != kF32) {
    if (al % 2 == 0) return launch<KIND, 2>(a, stream);
  }
  if constexpr (KIND == kInt8 || KIND == kInt4) {
    return launch<KIND, 1>(a, stream);
  }
  return (int)cudaErrorMisalignedAddress;
}

// tensor_cores: the quantized pools' route, chosen by the caller
// (kernels/paged_attention.quant_kernel); the bf16 pages' is fixed by type
int run(Args a, int kind, int tensor_cores, void* stream) {
  if (a.G < 1 || a.G > kMaxG || a.hd < 1 || a.hd > kThreads * kMaxDPT ||
      (a.hmap == nullptr && a.H != a.G * a.KV) || a.NS < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == kBF16 && a.q_bf16) return launch_bf16(a, s);
  if (tensor_cores) return launch_quant_tc(a, kind, s);
  switch (kind) {
    case kF32: return launch_kind<kF32>(a, s);
    case kBF16: return launch_kind<kBF16>(a, s);
    case kInt8: return launch_kind<kInt8>(a, s);
    case kInt4: return launch_kind<kInt4>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// kind: 0 = f32 pages, 1 = bf16 pages. dims: B, H, KV, hd, NB, BS, MAXB,
// pps (pages per split), NS (splits), window, G (H / KV, or with a head
// map its largest group; part_acc / part_ml are (B, KV, NS, G, hd / 2)).
// hmap: null, or the head-map table on the device.
int paged_attention(const void* q, const void* k, const void* v,
                    const void* bt, const void* lens, void* o,
                    void* part_acc, void* part_ml, const void* hmap,
                    int q_bf16, int kind, const void* dims, float scale,
                    void* stream) {
  const int* dm = (const int*)dims;
  Args a{q, (const uint8_t*)k, (const uint8_t*)v, nullptr, nullptr,
         (const int*)bt, (const int*)lens, o, (float*)part_acc,
         (float*)part_ml, q_bf16, dm[0], dm[1], dm[2], dm[10], dm[3],
         dm[4], dm[5], dm[6], dm[7], dm[8], dm[9],
         dm[3] * (kind == 0 ? 4 : 2), scale, (const int*)hmap};
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  return run(a, kind, 0, stream);
}

// Quantized pool: kind 2 = int8 codes, 3 = 4-bit nibble pairs; ks/vs are
// (NB, KV) f32 page scales; tensor_cores 1 takes the tensor-core kernel
// (bf16 q; refused where it does not apply), 0 the CUDA-core one. dims as
// above.
int paged_attention_quant(const void* q, const void* k, const void* v,
                          const void* ks, const void* vs, const void* bt,
                          const void* lens, void* o, void* part_acc,
                          void* part_ml, const void* hmap, int q_bf16,
                          int kind, int tensor_cores, const void* dims,
                          float scale, void* stream) {
  const int* dm = (const int*)dims;
  Args a{q, (const uint8_t*)k, (const uint8_t*)v, (const float*)ks,
         (const float*)vs, (const int*)bt, (const int*)lens, o,
         (float*)part_acc, (float*)part_ml, q_bf16, dm[0], dm[1], dm[2],
         dm[10], dm[3], dm[4], dm[5], dm[6], dm[7], dm[8], dm[9],
         kind == 2 ? dm[3] : dm[3] / 2, scale, (const int*)hmap};
  if (kind != 2 && kind != 3) return (int)cudaErrorInvalidValue;
  return run(a, kind, tensor_cores, stream);
}

}  // extern "C"
