// flash_attention: block-causal (+ sliding-window) GQA attention with an
// online f32 softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas). Plain version:
// repro_torch.kernels.flash_attention.flash_attention_plain (the masked f32
// softmax of kernels/ref.flash_attention_ref, in the model's layout).
//
// Layout: the model's own q (B, Tq, H, hd) and k/v (B, Tk, KV, hd), read
// through element strides (hd contiguous); query head h reads KV head
// h / (H / KV). Output (B, Tq, H, hd) in the input type (bf16 or f32).
//
// What bounds it on the H100: at the main-path shapes (B=8, T=128 and
// B=1, T=512; H=28, KV=4, hd=128, bf16) it moves ~8.4 / ~4.2 MB (~2.5 /
// ~1.3 us at 3.35 TB/s) and needs ~0.95 / ~1.9 GFLOP of causal products
// (~1 / ~2 us at the bf16 tensor-core peak): bytes, or both.
//
// bf16 (the main path): FlashAttention-2 on warp-level tensor cores. One
// block takes 64 query rows of one (batch, head), 4 warps of 16 rows, two
// blocks an SM (__launch_bounds__). For hd <= 128 each warp loads its Q
// rows once, straight from global memory into mma A fragments (4-byte
// pairs); for hd > 128, where the registers go to the accumulators, Q is
// copied to shared memory once and re-read per tile through ldmatrix.
// K/V tiles of 64 keys stream through a 2-stage cp.async
// ring, read through the (B, T, KV, hd) strides, with rows padded by 16
// bytes so ldmatrix is free of bank conflicts and hd zero-padded to a
// multiple of 16 (8 .. 256). S = Q.K^T is mma.m16n8k16 (bf16 in, f32
// accumulate); the online softmax runs on the S fragments in registers
// (row reductions over the quad); P.V reuses the S fragments as A
// operands, with P split into bf16 hi + lo (two mmas) so the products keep
// about 16 bits of the f32 probability, as the TPU kernel keeps P in f32;
// V comes through ldmatrix.trans. Tiles above the diagonal or outside the
// window are never loaded; only tiles that cross the diagonal, the
// window's edge or Tk are masked. The epilogue divides by l in f32.
//
// f32: the CUDA-core kernel below (one block per 16 query rows, K/V
// tiles of 32 keys staged as f32, a lane scores one key): the precision
// path, held to 1e-4.
//
// LSE: with a non-null `lse` (B, H, Tq) f32 both kernels also write each
// row's log-sum-exp of its scaled scores, m + log(l) in natural units
// (+inf for a row that sees no key), which the backward kernel
// (flash_attention_bwd.cu) recomputes P from. With a null `lse` the
// inference paths pay one untaken branch a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kMaxDPL = 8;                  // hd <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

struct Strides {
  long long b, t, h;  // element strides of dims 0, 1, 2 (dim 3 is 1)
};

template <typename T>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ o,
                                       float* __restrict__ lse, Strides sq,
                                       Strides sk, Strides sv, Strides so,
                                       int Tq, int Tk, int H, int group,
                                       int hd, int causal, int window,
                                       float scale) {
  extern __shared__ float4 smem4[];
  const int hdp = (hd + 3) / 4 * 4 + 4;  // padded K row (floats), 16B rows
  float* ks = reinterpret_cast<float*>(smem4);  // [kBK][hdp]
  float* vs = ks + kBK * hdp;                   // [kBK][hd]
  float* qs = vs + kBK * hd;                    // [kBQ][hdp]

  const int b = blockIdx.z, h = blockIdx.y, g = h / group;
  const int q_lo = blockIdx.x * kBQ;
  const int q_hi = min(q_lo + kBQ, Tq) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // stage the block's query rows (f32, zero beyond Tq / hd)
  for (int i = tid; i < kBQ * hdp; i += nthr) {
    const int r = i / hdp, d = i % hdp, qi = q_lo + r;
    qs[i] = (qi < Tq && d < hd)
                ? to_f32(q[b * sq.b + qi * sq.t + h * sq.h + d])
                : 0.f;
  }

  int kv_end = Tk;                       // exclusive
  int kv_start = 0;
  if (causal) {
    kv_end = min(Tk, q_hi + 1);
    if (window > 0) kv_start = max(0, q_lo - window + 1);
  }
  const int dpl = (hd + 31) / 32;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxDPL; ++s) acc[r][s] = 0.f;
  }

  for (int kt = (kv_start / kBK) * kBK; kt < kv_end; kt += kBK) {
    __syncthreads();  // previous tile fully consumed (and qs staged)
    for (int i = tid; i < kBK * hd; i += nthr) {
      const int r = i / hd, d = i % hd, key = kt + r;
      float kv_k = 0.f, kv_v = 0.f;
      if (key < Tk) {
        kv_k = to_f32(k[b * sk.b + key * sk.t + g * sk.h + d]);
        kv_v = to_f32(v[b * sv.b + key * sv.t + g * sv.h + d]);
      }
      ks[r * hdp + d] = kv_k;
      vs[r * hd + d] = kv_v;
    }
    for (int i = tid; i < kBK * (hdp - hd); i += nthr) {
      ks[(i / (hdp - hd)) * hdp + hd + i % (hdp - hd)] = 0.f;
    }
    __syncthreads();

    const int key = kt + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qi = q_lo + row;
      if (qi >= Tq) continue;  // warp-uniform
      bool valid = key < Tk;
      if (causal) {
        valid = valid && key <= qi && (window <= 0 || qi - key < window);
      }
      float s = -INFINITY;
      if (valid) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + row * hdp);
        const float4* k4 = reinterpret_cast<const float4*>(ks + lane * hdp);
        float a0 = 0.f, a1 = 0.f;
        for (int d4 = 0; d4 < hdp / 4; ++d4) {
          const float4 x = q4[d4], y = k4[d4];
          a0 = fmaf(x.x, y.x, a0);
          a1 = fmaf(x.y, y.y, a1);
          a0 = fmaf(x.z, y.z, a0);
          a1 = fmaf(x.w, y.w, a1);
        }
        s = (a0 + a1) * scale;
      }
      const float tile_max = warp_max(s);
      if (tile_max == -INFINITY) continue;  // no live key for this row
      const float m_new = fmaxf(m[r], tile_max);
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int sl = 0; sl < kMaxDPL; ++sl) acc[r][sl] *= corr;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(~0u, p, j);
        const float* vrow = vs + j * hd;
#pragma unroll
        for (int sl = 0; sl < kMaxDPL; ++sl) {
          const int d = lane + 32 * sl;
          if (sl < dpl && d < hd) acc[r][sl] = fmaf(pj, vrow[d], acc[r][sl]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q_lo + warp * kRowsPerWarp + r;
    if (qi >= Tq) continue;
    const float lr = fmaxf(l[r], 1e-20f);
    if (lse != nullptr && lane == 0) {
      lse[((long long)b * H + h) * Tq + qi] =
          l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    }
#pragma unroll
    for (int sl = 0; sl < kMaxDPL; ++sl) {
      const int d = lane + 32 * sl;
      if (sl < dpl && d < hd) {
        store(o + b * so.b + qi * so.t + h * so.h + d, acc[r][sl] / lr);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, const long long* st, int B, int Tq, int Tk, int H, int KV, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const int hdp = (hd + 3) / 4 * 4 + 4;
  const size_t smem = sizeof(float) * ((size_t)kBK * hdp + (size_t)kBK * hd +
                                       (size_t)kBQ * hdp);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, sk, sv, so, Tq,
      Tk, H, H / KV, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) fed by a 2-stage cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcKeys = 64;             // keys per K/V tile
constexpr int kTcStages = 2;
constexpr int kRowPad = 8;  // bf16 elements (16 bytes) added to each row

using bf16 = __nv_bfloat16;

// KD: 16-wide steps of the zero-padded head dim (HD = 16 * KD >= hd).
template <int KD>
__global__ void __launch_bounds__(kTcWarps * 32, 2)
    flash_attention_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ o,
                              float* __restrict__ lse, Strides sq, Strides sk,
                              Strides sv, Strides so, int Tq, int Tk,
                              int group, int hd, int causal, int window,
                              float scale_log2, int w) {
  using namespace mma_bf16;
  constexpr int HD = 16 * KD;
  constexpr int LD = HD + kRowPad;  // row stride (elements): 16 B odd
  constexpr int LDB = 2 * LD;       // row stride (bytes)
  constexpr bool kQInRegs = KD <= 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kTcStages][kTcKeys][LD]
  bf16* vs = ks + kTcStages * kTcKeys * LD;      // [kTcStages][kTcKeys][LD]
  bf16* qs = vs + kTcStages * kTcKeys * LD;      // [kTcRows][LD] if hd > 128
  constexpr int kAllRows =
      2 * kTcStages * kTcKeys + (kQInRegs ? 0 : kTcRows);

  const int b = blockIdx.z, h = blockIdx.y, g = h / group;
  const int q_lo = blockIdx.x * kTcRows;
  const int q_last = min(q_lo + kTcRows, Tq) - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // zero the pad columns [hd, HD) of every row (K, V, then Q) once:
  // cp.async writes only [0, hd), so they stay zero (hd is even)
  for (int i = tid; i < kAllRows * (HD - hd) / 2; i += kTcWarps * 32) {
    const int r = i / ((HD - hd) / 2), c = hd + 2 * (i % ((HD - hd) / 2));
    *reinterpret_cast<uint32_t*>(ks + r * LD + c) = 0u;
  }

  // n_rows rows of a tile from src + r * row_stride, in w-byte chunks
  // (rows r >= n_valid zero-filled)
  const int cpr = 2 * hd / w;  // cp.async chunks per row
  auto load_rows = [&](bf16* dst, int n_rows, const bf16* src,
                       long long row_stride, int n_valid) {
    for_each_chunk(n_rows, cpr, tid, kTcWarps * 32, [&](int r, int c) {
      const bool ok = r < n_valid;
      const char* from =
          reinterpret_cast<const char*>(ok ? src + r * row_stride : src) +
          c * w;
      cp_async_w(smem_u32(reinterpret_cast<char*>(dst + r * LD) + c * w),
                 from, ok, w);
    });
  };
  const bf16* k_bh = k + b * sk.b + g * sk.h;
  const bf16* v_bh = v + b * sv.b + g * sv.h;
  auto load_tile = [&](int stage, int kt) {
    load_rows(ks + stage * kTcKeys * LD, kTcKeys, k_bh + kt * sk.t, sk.t,
              Tk - kt);
    load_rows(vs + stage * kTcKeys * LD, kTcKeys, v_bh + kt * sv.t, sv.t,
              Tk - kt);
  };

  int kv_lo = 0, kv_hi = Tk;  // keys any row of the block can see
  if (causal) {
    kv_hi = min(Tk, q_last + 1);
    if (window > 0) kv_lo = max(0, q_lo - window + 1);
  }
  const int t_first = kv_lo / kTcKeys;
  const int n_tiles = kv_hi > 0 ? (kv_hi + kTcKeys - 1) / kTcKeys - t_first
                                : 0;

  const bf16* q_bh = q + b * sq.b + h * sq.h;
  if (!kQInRegs) load_rows(qs, kTcRows, q_bh + q_lo * sq.t, sq.t, Tq - q_lo);
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, (t_first + st) * kTcKeys);
    cp_async_commit();
  }

  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = q_lo + warp * 16 + gid;  // rows of c0/c1 and c2/c3
  const uint32_t q_lane =
      lane_addr_a(smem_u32(qs + warp * 16 * LD), LDB, lane);
  // hd <= 128: the warp's 16 Q rows as A fragments, straight from global
  // memory (4-byte pairs; zero past Tq and hd)
  uint32_t qf[kQInRegs ? KD : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e & 1);
        const int col = 16 * kk + 2 * tig + 8 * (e >> 1);
        qf[kk][e] = row < Tq && col < hd
                        ? *reinterpret_cast<const uint32_t*>(q_bh +
                                                             row * sq.t + col)
                        : 0u;
      }
  }
  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kTcStages - 2>();  // tile `it` (and Q) has landed
    __syncthreads();  // ... for every thread; stage (it - 1) % S is free
    if (it + kTcStages - 1 < n_tiles)
      load_tile((it + kTcStages - 1) % kTcStages,
                (t_first + it + kTcStages - 1) * kTcKeys);
    cp_async_commit();
    const int kt = (t_first + it) * kTcKeys;
    const int stage = it % kTcStages;
    const uint32_t k_lane = lane_addr_b(
        smem_u32(ks + stage * kTcKeys * LD), LDB, lane);
    const uint32_t v_lane = lane_addr_a(
        smem_u32(vs + stage * kTcKeys * LD), LDB, lane);

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_lane + 32 * kk);
      }
      uint32_t bk[kTcKeys / 16][4];  // the step's K fragments, then mmas
#pragma unroll
      for (int j = 0; j < kTcKeys / 16; ++j)
        ldmatrix_x4(bk[j], k_lane + 16 * j * LDB + 32 * kk);
#pragma unroll
      for (int j = 0; j < kTcKeys / 16; ++j) {
        mma_16816(s[2 * j], a, bk[j][0], bk[j][1]);
        mma_16816(s[2 * j + 1], a, bk[j][2], bk[j][3]);
      }
    }

    // scale to log2 units; mask only tiles that cross Tk, the diagonal
    // or the window's edge
    const bool edge =
        kt + kTcKeys > Tk ||
        (causal && (kt + kTcKeys - 1 > q_lo ||
                    (window > 0 && q_last - kt >= window)));
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = kt + 8 * n + 2 * tig + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          bool ok = key < Tk;
          if (causal)
            ok = ok && key <= row && (window <= 0 || row - key < window);
          if (!ok) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }

    float corr[2];
    online_softmax<kTcKeys / 8>(s, m, l, corr);
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V, 16 keys a step
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j)
      pv_split<KD>(acc, s[2 * j], s[2 * j + 1], v_lane + 16 * j * LDB);
  }
  cp_async_wait<0>();

  // epilogue: divide by l (f32), write bf16 pairs through o's strides
  float inv[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(lsum[r], 1e-20f);
  }
  if (lse != nullptr && tig == 0) {  // m is in log2 units: back to natural
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Tq)
        lse[((long long)b * gridDim.y + h) * Tq + row] =
            lsum[r] > 0.f ? (m[r] + log2f(lsum[r])) * 0.6931471805599453f
                          : INFINITY;
    }
  }
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n) {
    const int col = 8 * n + 2 * tig;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Tq) continue;
      *reinterpret_cast<__nv_bfloat162*>(o + b * so.b + row * so.t +
                                         h * so.h + col) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv[r],
                                acc[n][2 * r + 1] * inv[r]);
    }
  }
}

template <int KD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, const long long* st, int B, int Tq, int Tk, int H, int KV,
              int hd, int causal, int window, float scale, int w,
              cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const size_t smem = sizeof(bf16) * (16 * KD + kRowPad) *
                      (2 * kTcStages * kTcKeys + (KD <= 8 ? 0 : kTcRows));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<KD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Tq + kTcRows - 1) / kTcRows, H, B);
  flash_attention_tc_kernel<KD><<<grid, kTcWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, sq, sk,
      sv, so, Tq, Tk, H / KV, hd, causal, window, scale * 1.4426950408889634f,
      w);
  return (int)cudaGetLastError();
}

// the widest cp.async (16, 8 or 4 bytes) that divides every row's bytes
// and start: the base pointers, the byte strides and 2 * hd
int copy_width(const void* q, const void* k, const void* v,
               const long long* st, int hd) {
  uintptr_t al = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                 (uintptr_t)(2 * hd);
  for (int i = 0; i < 9; ++i) al |= (uintptr_t)(2 * st[i]);
  return al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : al % 4 == 0 ? 4 : 0;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int Tq, int Tk, int H, int KV,
                int hd, int causal, int window, float scale,
                cudaStream_t stream) {
  const int w = copy_width(q, k, v, st, hd);
  if (w == 0 || hd % 2) return (int)cudaErrorMisalignedAddress;
  const int steps = (hd + 15) / 16;
#define REPRO_FLASH_TC(KD)                                                  \
  return launch_tc<KD>(q, k, v, o, lse, st, B, Tq, Tk, H, KV, hd, causal,  \
                       window, scale, w, stream)
  if (steps <= 1) REPRO_FLASH_TC(1);
  if (steps <= 2) REPRO_FLASH_TC(2);
  if (steps <= 4) REPRO_FLASH_TC(4);
  if (steps <= 8) REPRO_FLASH_TC(8);
  REPRO_FLASH_TC(16);
#undef REPRO_FLASH_TC
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16. strides: host array of 12 int64 element
// strides, dims 0..2 of q, k, v, o in that order. lse: null, or a
// contiguous (B, H, Tq) f32 output. Requires hd <= 256 and H % KV == 0.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    void* lse, const void* strides, int dtype, int B, int Tq, int Tk,
                    int H, int KV, int hd, int causal, int window, float scale,
                    void* stream) {
  const long long* st = (const long long*)strides;
  if (hd > 32 * kMaxDPL || H % KV) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return launch_bf16(q, k, v, o, (float*)lse, st, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, (cudaStream_t)stream);
  }
  return launch<float>(q, k, v, o, (float*)lse, st, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, (cudaStream_t)stream);
}

}  // extern "C"
