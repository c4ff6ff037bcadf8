// flash_attention_bwd: the gradient of flash_attention (causal, sliding-
// window or non-causal GQA attention) with respect to q, k and v, for
// Hopper (sm_90a).
//
// The JAX package has no backward Pallas kernel: it differentiates its
// jax.checkpoint'ed block pair-scan (src/repro/models/attention.py) with
// XLA. The port's forward is a hand-written kernel (flash_attention.cu),
// so its backward is one too. Plain version: the autograd graph of
// repro_torch.kernels.flash_attention.flash_attention_plain.
//
// The math is FlashAttention-2's. The forward saves each row's log-sum-exp
// of its scaled scores (LSE, (B, H, Tq) f32); the backward never stores P:
//   P   = exp(scale * q.k - LSE)                  recomputed tile by tile
//   dV  = P^T dO,  dP = dO V^T
//   D   = rowsum(P * dP)                          (= rowsum(dO * O))
//   dS  = P * (dP - D)
//   dK  = scale * dS^T Q,  dQ = scale * dS K.
// D is summed from P and dP in f32, as the softmax's autograd (and the JAX
// package's differentiated pair scan) forms it, not from the stored
// output: a bf16 O carries a 2^-9 relative error into D, and where the
// attention is near-hard dP ~ D, so dS = P (dP - D) would inherit it
// whole.
//
// bf16 (the main path): warp-level tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate) over the forward's helpers (mma_bf16.cuh). Rows of
// every tile are padded by 16 bytes (ldmatrix free of bank conflicts) and
// hd is zero-padded to a multiple of 16; tiles stream through a 2-stage
// cp.async ring read through the (B, T, heads, hd) strides. A warp holds
// 32 columns of a 64-wide score tile at a time (kernel A at hd 128: all
// 64), so the score fragments cost 32 (64) registers beside the
// accumulators.
// - Kernel A (dQ and D): one block per (batch, query head, 64 query rows),
//   4 warps of 16 rows. Q and dO rows come in once; K/V tiles of 64 keys
//   stream twice, the second pass following the first in the same ring.
//   S = Q K^T and dP = dO V^T on tensor cores; P = exp2(S scale log2e -
//   LSE log2e) on the C fragments. Pass 1 sums D over the quad in f32
//   and writes it to the dsum workspace; pass 2 forms dS = P (dP - D) and
//   accumulates dQ += dS K with dS's C fragments reused as A fragments,
//   split into bf16 hi + lo (the forward's split-P: ~16 bits of dS). dQ
//   is scaled and rounded to bf16 once.
// - Kernel B (dK and dV, after A on the stream): one block per (batch, kv
//   head, 64 keys, split s), 4 warps of 16 keys. K and V come in once; the
//   block walks its share of the (query head of the group, 64-row query
//   tile) pairs that can see its keys, Q / dO tiles with their LSE and D
//   through the ring. S^T = K Q^T and dP^T = V dO^T on tensor cores, P^T
//   and dS^T = P^T (dP^T - D) on the fragments, then dV += P^T dO and dK
//   += dS^T Q with P^T and dS^T split hi + lo. The GQA group is summed in
//   the block, with no K/V expansion in memory.
// - The split (kernels/flash_attention.plan_bwd): pair p of a key block's
//   n goes to split s with s n / nsplit <= p < (s + 1) n / nsplit. With
//   nsplit = 1 kernel B writes bf16 dK / dV; otherwise each split writes
//   f32 partials to a (2, nsplit, B, Tk, KV, hd) workspace and kernel C
//   sums them in split order, scales dK and rounds to bf16.
// - hd > 128: the dK and dV accumulators of 16 keys by 256 dims would take
//   256 registers a thread, so kernel B's grid takes the output dims in
//   two halves of 128 (each half recomputes S^T and dP^T over the full hd;
//   an hd of 256 occurs only in the tests); kernel A keeps its 128-register
//   dQ tile and spills ~100 bytes a thread. Both hold their 64-row tiles
//   in shared memory (203 KB at hd 256, one block an SM), as the forward's
//   hd > 128 case holds Q.
// Tiles wholly above the diagonal, outside the window or past T are never
// loaded; only tiles that cross the diagonal, the window's edge or T are
// masked. No block writes a location another block writes and no atomics
// are used, so the gradients are bit-for-bit deterministic run to run.
//
// f32: the CUDA-core kernels below (the precision path, held to 1e-4): a
// dq kernel, one block per (batch, query head, 16 query rows) with a D
// pass and a dS pass over 32-key tiles, a lane scoring one key; a dkdv
// kernel, one block per (batch, kv head, 32 keys) walking the group's
// 16-row query tiles, its dK / dV in registers.
//
// Masks as the forward's: key s is visible from query t when s < Tk and,
// if causal, s <= t and (window <= 0 or t - s < window). Tq and Tk are
// free (the VLM's cross layer; non-causal), T need not divide the tiles,
// hd <= 256 (bf16: even).
//
// What bounds it on the H100: it reads q, k, v, dO and the LSE and writes
// dQ, dK, dV (at qwen's training shape, B=8 T=128, 28/4 heads, hd 128,
// ~7 x 2 MB in bf16), and the math is 5 products of the forward's size
// (S, dP, dV, dK, dQ: 10 hd operations a visible (query, key) pair). This
// design runs 12: S and dP in kernel A's two passes and again in kernel
// B, and dQ, dK, dV at two mmas each (hi + lo). Its ceiling is therefore
// 2.4x the operations bound at the tensor cores' peak, before the masked
// halves of diagonal tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;                      // keys per tile, one per lane
constexpr int kBQ = 16;                      // query rows per tile
constexpr int kRowsPerWarp = kBQ / kWarps;   // 4
constexpr int kKeysPerWarp = kBK / kWarps;   // 8

struct Strides {
  long long b, t, h;  // element strides of dims 0, 1, 2 (dim 3 is 1)
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int qi, int key, int Tk, int causal,
                                        int window) {
  if (key >= Tk) return false;
  if (!causal) return true;
  return key <= qi && (window <= 0 || qi - key < window);
}

// hd padded to a multiple of 4, plus 4 floats: 16-byte rows for float4
// dot products, rows offset by 4 banks
__host__ __device__ __forceinline__ int padded(int hd) {
  return (hd + 3) / 4 * 4 + 4;
}

// rows [r0, r0 + n_rows) of a (.., T, heads, hd) tensor at head `h` as f32
// into dst[n_rows][hdp]; rows >= T and columns >= hd are zero
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           Strides s, int b, int h, int r0,
                                           int n_rows, int n_valid, int hd,
                                           int hdp) {
  for (int i = threadIdx.x; i < n_rows * hdp; i += kThreads) {
    const int r = i / hdp, d = i % hdp;
    dst[i] = (r < n_valid && d < hd)
                 ? ld(src + b * s.b + (long long)(r0 + r) * s.t + h * s.h + d)
                 : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b,
                                     int hdp) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float x0 = 0.f, x1 = 0.f;
  for (int d4 = 0; d4 < hdp / 4; ++d4) {
    const float4 x = a4[d4], y = b4[d4];
    x0 = fmaf(x.x, y.x, x0);
    x1 = fmaf(x.y, y.y, x1);
    x0 = fmaf(x.z, y.z, x0);
    x1 = fmaf(x.w, y.w, x1);
  }
  return x0 + x1;
}

// dQ: grid (ceil(Tq / kBQ), H, B)
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 float* __restrict__ dsum, T* __restrict__ dq,
                 Strides sq, Strides sk, Strides sv, Strides sdo,
                 Strides sdq, int Tq, int Tk, int H, int group, int hd,
                 int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  const int hdp = padded(hd);
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][hdp]
  float* dos = qs + kBQ * hdp;                  // [kBQ][hdp]
  float* ks = dos + kBQ * hdp;                  // [kBK][hdp]
  float* vs = ks + kBK * hdp;                   // [kBK][hdp]

  const int b = blockIdx.z, h = blockIdx.y, g = h / group;
  const int q_lo = blockIdx.x * kBQ;
  const int q_hi = min(q_lo + kBQ, Tq) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  stage_rows(qs, q, sq, b, h, q_lo, kBQ, Tq - q_lo, hd, hdp);
  stage_rows(dos, dout, sdo, b, h, q_lo, kBQ, Tq - q_lo, hd, hdp);

  float row_lse[kRowsPerWarp], row_d[kRowsPerWarp];
  float acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q_lo + warp * kRowsPerWarp + r;
    const long long at = ((long long)b * H + h) * Tq + qi;
    row_lse[r] = qi < Tq ? lse[at] : INFINITY;
    row_d[r] = 0.f;
#pragma unroll
    for (int s = 0; s < DPL; ++s) acc[r][s] = 0.f;
  }

  int kv_lo = 0, kv_hi = Tk;  // keys any row of the block can see
  if (causal) {
    kv_hi = min(Tk, q_hi + 1);
    if (window > 0) kv_lo = max(0, q_lo - window + 1);
  }
  // pass 1: D = rowsum(P * dP), a lane's keys summed in tile order, then
  // across the warp
  for (int kt = kv_lo / kBK * kBK; kt < kv_hi; kt += kBK) {
    __syncthreads();  // the previous tile is consumed (and q / dO staged)
    stage_rows(ks, k, sk, b, g, kt, kBK, Tk - kt, hd, hdp);
    stage_rows(vs, v, sv, b, g, kt, kBK, Tk - kt, hd, hdp);
    __syncthreads();
    const int key = kt + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r, qi = q_lo + row;
      if (qi < Tq && visible(qi, key, Tk, causal, window)) {
        const float p =
            expf(dot(qs + row * hdp, ks + lane * hdp, hdp) * scale -
                 row_lse[r]);
        row_d[r] = fmaf(p, dot(dos + row * hdp, vs + lane * hdp, hdp),
                        row_d[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    row_d[r] = warp_sum(row_d[r]);
    const int qi = q_lo + warp * kRowsPerWarp + r;
    if (lane == 0 && qi < Tq)
      dsum[((long long)b * H + h) * Tq + qi] = row_d[r];
  }

  // pass 2: dS = P * (dP - D), dQ = scale * dS K
  for (int kt = kv_lo / kBK * kBK; kt < kv_hi; kt += kBK) {
    __syncthreads();  // the previous tile is consumed (and q / dO staged)
    stage_rows(ks, k, sk, b, g, kt, kBK, Tk - kt, hd, hdp);
    stage_rows(vs, v, sv, b, g, kt, kBK, Tk - kt, hd, hdp);
    __syncthreads();
    const int key = kt + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r, qi = q_lo + row;
      if (qi >= Tq) continue;  // warp-uniform
      float ds = 0.f;
      if (visible(qi, key, Tk, causal, window)) {
        const float p =
            expf(dot(qs + row * hdp, ks + lane * hdp, hdp) * scale -
                 row_lse[r]);
        const float dp = dot(dos + row * hdp, vs + lane * hdp, hdp);
        ds = p * (dp - row_d[r]);
      }
      for (int j = 0; j < kBK; ++j) {
        const float dsj = __shfl_sync(~0u, ds, j);
        const float* krow = ks + j * hdp;
#pragma unroll
        for (int s = 0; s < DPL; ++s)
          acc[r][s] = fmaf(dsj, krow[lane + 32 * s], acc[r][s]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q_lo + warp * kRowsPerWarp + r;
    if (qi >= Tq) continue;
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      const int d = lane + 32 * s;
      if (d < hd)
        st(dq + b * sdq.b + (long long)qi * sdq.t + h * sdq.h + d,
           acc[r][s] * scale);
    }
  }
}

// dK, dV: grid (ceil(Tk / kBK), KV, B)
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dk,
                   T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, int Tq, int Tk,
                   int H, int group, int hd, int causal, int window,
                   float scale) {
  extern __shared__ float4 smem4[];
  const int hdp = padded(hd);
  float* ks = reinterpret_cast<float*>(smem4);  // [kBK][hdp]
  float* vs = ks + kBK * hdp;                   // [kBK][hdp]
  float* qs = vs + kBK * hdp;                   // [kBQ][hdp]
  float* dos = qs + kBQ * hdp;                  // [kBQ][hdp]
  float* ps = dos + kBQ * hdp;                  // [kBQ][kBK]
  float* dss = ps + kBQ * kBK;                  // [kBQ][kBK]

  const int b = blockIdx.z, g = blockIdx.y;
  const int k_lo = blockIdx.x * kBK;
  const int k_last = min(k_lo + kBK, Tk) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = k_lo + lane;

  stage_rows(ks, k, sk, b, g, k_lo, kBK, Tk - k_lo, hd, hdp);
  stage_rows(vs, v, sv, b, g, k_lo, kBK, Tk - k_lo, hd, hdp);

  float acc_k[kKeysPerWarp][DPL], acc_v[kKeysPerWarp][DPL];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j)
#pragma unroll
    for (int s = 0; s < DPL; ++s) acc_k[j][s] = acc_v[j][s] = 0.f;

  int q_first = 0, q_end = Tq;  // queries that can see some key of the block
  if (causal) {
    q_first = k_lo;
    if (window > 0) q_end = min(Tq, k_last + window);
  }
  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    for (int qt = q_first / kBQ * kBQ; qt < q_end; qt += kBQ) {
      __syncthreads();  // the previous tile's rows and P / dS are consumed
      stage_rows(qs, q, sq, b, h, qt, kBQ, Tq - qt, hd, hdp);
      stage_rows(dos, dout, sdo, b, h, qt, kBQ, Tq - qt, hd, hdp);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r, qi = qt + row;
        float p = 0.f, ds = 0.f;
        if (qi < Tq && visible(qi, key, Tk, causal, window)) {
          const long long at = ((long long)b * H + h) * Tq + qi;
          p = expf(dot(qs + row * hdp, ks + lane * hdp, hdp) * scale -
                   lse[at]);
          const float dp = dot(dos + row * hdp, vs + lane * hdp, hdp);
          ds = p * (dp - dsum[at]);
        }
        ps[row * kBK + lane] = p;
        dss[row * kBK + lane] = ds;
      }
      __syncthreads();
      for (int i = 0; i < kBQ; ++i) {
        const float* qrow = qs + i * hdp;
        const float* dorow = dos + i * hdp;
#pragma unroll
        for (int j = 0; j < kKeysPerWarp; ++j) {
          const float p = ps[i * kBK + warp * kKeysPerWarp + j];
          const float ds = dss[i * kBK + warp * kKeysPerWarp + j];
#pragma unroll
          for (int s = 0; s < DPL; ++s) {
            acc_v[j][s] = fmaf(p, dorow[lane + 32 * s], acc_v[j][s]);
            acc_k[j][s] = fmaf(ds, qrow[lane + 32 * s], acc_k[j][s]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int kj = k_lo + warp * kKeysPerWarp + j;
    if (kj >= Tk) continue;
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      const int d = lane + 32 * s;
      if (d < hd) {
        st(dk + b * sdk.b + (long long)kj * sdk.t + g * sdk.h + d,
           acc_k[j][s] * scale);
        st(dv + b * sdv.b + (long long)kj * sdv.t + g * sdv.h + d,
           acc_v[j][s]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) fed by a 2-stage cp.async ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTile = 16 * kTcWarps;  // rows a block owns; rows of a tile
constexpr int kSub = 32;              // score columns a warp holds at once
constexpr int kStages = 2;
constexpr int kRowPad = 8;  // bf16 elements (16 bytes) added to each row
constexpr float kLog2e = 1.4426950408889634f;

// zero the pad columns [hd, HD) of n_rows consecutive rows once: cp.async
// writes only [0, hd), so they stay zero (hd is even)
__device__ __forceinline__ void zero_pad(bf16* base, int n_rows, int ld,
                                         int hd, int HD) {
  const int per = (HD - hd) / 2;
  for (int i = threadIdx.x; i < n_rows * per; i += kTcThreads) {
    const int r = i / per, c = hd + 2 * (i % per);
    *reinterpret_cast<uint32_t*>(base + r * ld + c) = 0u;
  }
}

// kTile rows from src + r * row_stride into dst (row stride ld elements)
// in w-byte chunks, cpr of them a row; rows r >= n_valid are zero-filled
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long row_stride, int n_valid,
                                          int cpr, int w) {
  using namespace mma_bf16;
  for_each_chunk(kTile, cpr, threadIdx.x, kTcThreads, [&](int r, int c) {
    const bool ok = r < n_valid;
    const char* from =
        reinterpret_cast<const char*>(ok ? src + r * row_stride : src) +
        c * w;
    cp_async_w(smem_u32(reinterpret_cast<char*>(dst + r * ld) + c * w), from,
               ok, w);
  });
}

// Kernel A, dQ and D: grid (ceil(Tq / kTile), H, B). KD: 16-wide steps of
// the zero-padded head dim (HD = 16 * KD >= hd).
template <int KD>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, int Tq, int Tk, int group,
                    int hd, int causal, int window, float scale, int w) {
  using namespace mma_bf16;
  constexpr int HD = 16 * KD;
  constexpr int LD = HD + kRowPad;  // row stride (elements): 16 B odd
  constexpr int LDB = 2 * LD;       // row stride (bytes)
  // keys of S a warp holds at once: 64 at hd 128 (faster there,
  // tools/flash_bwd_ab.py a-sub32), 32 elsewhere (64 was slower at hd 64;
  // at hd > 128 the registers go to the dQ tile)
  constexpr int SUB = KD == 8 ? 64 : kSub;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* dos = qs + kTile * LD;                   // [kTile][LD]
  bf16* ks = dos + kTile * LD;                   // [kStages][kTile][LD]
  bf16* vs = ks + kStages * kTile * LD;          // [kStages][kTile][LD]

  const int H = gridDim.y;
  const int b = blockIdx.z, h = blockIdx.y, g = h / group;
  const int q_lo = blockIdx.x * kTile;
  const int q_last = min(q_lo + kTile, Tq) - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * kLog2e;

  zero_pad(qs, (2 + 2 * kStages) * kTile, LD, hd, HD);
  const int cpr = 2 * hd / w;  // cp.async chunks per row
  const bf16* k_bh = k + b * sk.b + g * sk.h;
  const bf16* v_bh = v + b * sv.b + g * sv.h;
  auto load_tile = [&](int stage, int kt) {
    load_rows(ks + stage * kTile * LD, LD, k_bh + kt * sk.t, sk.t, Tk - kt,
              cpr, w);
    load_rows(vs + stage * kTile * LD, LD, v_bh + kt * sv.t, sv.t, Tk - kt,
              cpr, w);
  };

  int kv_lo = 0, kv_hi = Tk;  // keys any row of the block can see
  if (causal) {
    kv_hi = min(Tk, q_last + 1);
    if (window > 0) kv_lo = max(0, q_lo - window + 1);
  }
  // kv_hi >= 1 (q_last >= 0, Tk >= 1), so every block has a tile
  const int t_first = kv_lo / kTile;
  const int n_tiles = (kv_hi + kTile - 1) / kTile - t_first;

  load_rows(qs, LD, q + b * sq.b + h * sq.h + q_lo * sq.t, sq.t, Tq - q_lo,
            cpr, w);
  load_rows(dos, LD, dout + b * sdo.b + h * sdo.h + q_lo * sdo.t, sdo.t,
            Tq - q_lo, cpr, w);
  load_tile(0, t_first * kTile);
  cp_async_commit();

  const int row0 = q_lo + warp * 16 + gid;  // rows of c0/c1 and c2/c3
  const long long lse_at = ((long long)b * H + h) * Tq;
  float lse2[2];  // the rows' LSE in log2 units (+inf: no row, P = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Tq ? lse[lse_at + row] * kLog2e : INFINITY;
  }
  const uint32_t q_a = lane_addr_a(smem_u32(qs + warp * 16 * LD), LDB, lane);
  const uint32_t do_a =
      lane_addr_a(smem_u32(dos + warp * 16 * LD), LDB, lane);

  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float dpart[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};

  // pass 1 (it < n_tiles) sums D; pass 2 re-streams the same tiles
  for (int it = 0; it < 2 * n_tiles; ++it) {
    cp_async_wait<0>();  // tile `it` (and Q, dO) has landed
    __syncthreads();     // ... for every thread; the other stage is free
    if (it + 1 < 2 * n_tiles)
      load_tile((it + 1) % kStages, (t_first + (it + 1) % n_tiles) * kTile);
    cp_async_commit();
    const bool pass2 = it >= n_tiles;
    if (it == n_tiles) {  // D = rowsum(P dP): the quad's shares, in f32
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        D[r] = quad_sum(dpart[r]);
        const int row = row0 + 8 * r;
        if (tig == 0 && row < Tq) dsum[lse_at + row] = D[r];
      }
    }
    const int kt = (t_first + it % n_tiles) * kTile;
    const int stage = it % kStages;
    const uint32_t k_base = smem_u32(ks + stage * kTile * LD);
    const uint32_t v_base = smem_u32(vs + stage * kTile * LD);
    const uint32_t k_b = lane_addr_b(k_base, LDB, lane);
    const uint32_t v_b = lane_addr_b(v_base, LDB, lane);
    const uint32_t k_a = lane_addr_a(k_base, LDB, lane);
    const bool edge =
        kt + kTile > Tk ||
        (causal && (kt + kTile - 1 > q_lo ||
                    (window > 0 && q_last - kt >= window)));

#pragma unroll
    for (int sub = 0; sub < kTile / SUB; ++sub) {
      // S = Q K^T and dP = dO V^T: 16 rows x SUB keys
      float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4], ado[4];
        ldmatrix_x4(aq, q_a + 32 * kk);
        ldmatrix_x4(ado, do_a + 32 * kk);
#pragma unroll
        for (int j = 0; j < SUB / 16; ++j) {
          const int off = (sub * SUB + 16 * j) * LDB + 32 * kk;
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, k_b + off);
          ldmatrix_x4(bv, v_b + off);
          mma_16816(s[2 * j], aq, bk[0], bk[1]);
          mma_16816(s[2 * j + 1], aq, bk[2], bk[3]);
          mma_16816(dp[2 * j], ado, bv[0], bv[1]);
          mma_16816(dp[2 * j + 1], ado, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(fmaf(s[n][e], scale_log2, -lse2[r]));
          if (edge) {
            const int key = kt + sub * SUB + 8 * n + 2 * tig + (e & 1);
            if (!visible(row0 + 8 * r, key, Tk, causal, window)) p = 0.f;
          }
          if (pass2) {
            s[n][e] = p * (dp[n][e] - D[r]);  // dS
          } else {
            dpart[r] = fmaf(p, dp[n][e], dpart[r]);
          }
        }
      }
      // dQ += dS K, 16 keys a step, dS split into bf16 hi + lo
      if (pass2) {
#pragma unroll
        for (int j = 0; j < SUB / 16; ++j)
          pv_split<KD>(acc, s[2 * j], s[2 * j + 1],
                       k_a + (sub * SUB + 16 * j) * LDB);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < 2 * KD; ++n) {
    const int col = 8 * n + 2 * tig;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Tq) continue;
      *reinterpret_cast<__nv_bfloat162*>(dq + b * sdq.b + row * sdq.t +
                                         h * sdq.h + col) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale,
                                acc[n][2 * r + 1] * scale);
    }
  }
}

// Kernel B, dK and dV: grid (ceil(Tk / kTile), KV, B * nsplit * parts).
// OD: 16-wide steps of the output dims a block accumulates (the dims
// [16 OD part, 16 OD (part + 1)) of KD / OD parts). work: null when
// nsplit == 1, else the (2, nsplit, B, Tk, KV, hd) f32 partials.
// Three blocks an SM at hd <= 64 (fewer registers; measured faster at
// granite's and vit's shapes, tools/flash_bwd_ab.py b-minb2).
template <int KD, int OD>
__global__ void __launch_bounds__(kTcThreads, KD <= 4 ? 3 : 2)
    flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ work,
                      Strides sq, Strides sk, Strides sv, Strides sdo,
                      Strides sdk, Strides sdv, int B, int Tq, int Tk, int H,
                      int group, int hd, int causal, int window, float scale,
                      int nsplit, int w) {
  using namespace mma_bf16;
  constexpr int HD = 16 * KD;
  constexpr int LD = HD + kRowPad;
  constexpr int LDB = 2 * LD;
  constexpr int kParts = KD / OD;
  constexpr int SUB = kSub;  // queries of S^T a warp holds at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* vs = ks + kTile * LD;                    // [kTile][LD]
  bf16* qs = vs + kTile * LD;                    // [kStages][kTile][LD]
  bf16* dos = qs + kStages * kTile * LD;         // [kStages][kTile][LD]
  float* ls = reinterpret_cast<float*>(dos + kStages * kTile * LD);
  float* ds = ls + kStages * kTile;              // [kStages][kTile] each

  const int KV = gridDim.y, g = blockIdx.y;
  const int part = blockIdx.z % kParts;
  const int split = blockIdx.z / kParts % nsplit;
  const int b = blockIdx.z / kParts / nsplit;
  const int k_lo = blockIdx.x * kTile;
  const int k_last = min(k_lo + kTile, Tk) - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * kLog2e;

  zero_pad(ks, (2 + 2 * kStages) * kTile, LD, hd, HD);
  const int cpr = 2 * hd / w;
  load_rows(ks, LD, k + b * sk.b + g * sk.h + k_lo * sk.t, sk.t, Tk - k_lo,
            cpr, w);
  load_rows(vs, LD, v + b * sv.b + g * sv.h + k_lo * sv.t, sv.t, Tk - k_lo,
            cpr, w);

  // the query tiles t0 .. t0 + nt - 1 hold every query that can see a key
  // of the block; the block's pairs are (head hh, tile) = (p / nt, p % nt)
  int q_first = 0, q_end = Tq;
  if (causal) {
    q_first = k_lo;
    if (window > 0) q_end = min(Tq, k_last + window);
  }
  const int t0 = q_first / kTile;
  const int nt = q_end > q_first ? (q_end + kTile - 1) / kTile - t0 : 0;
  const int n_pairs = group * nt;
  const int p_lo = (int)((long long)split * n_pairs / nsplit);
  const int p_hi = (int)((long long)(split + 1) * n_pairs / nsplit);

  auto load_pair = [&](int stage, int p) {
    const int h = g * group + p / nt, qt = (t0 + p % nt) * kTile;
    load_rows(qs + stage * kTile * LD, LD,
              q + b * sq.b + h * sq.h + qt * sq.t, sq.t, Tq - qt, cpr, w);
    load_rows(dos + stage * kTile * LD, LD,
              dout + b * sdo.b + h * sdo.h + qt * sdo.t, sdo.t, Tq - qt, cpr,
              w);
    // the tile's LSE (threads 0-63) and D (64-127), 4 bytes each
    const long long at = ((long long)b * H + h) * Tq + qt;
    const int i = tid % kTile;
    const float* src = (tid < kTile ? lse : dsum) + at;
    const bool ok = qt + i < Tq;
    cp_async<4>(smem_u32((tid < kTile ? ls : ds) + stage * kTile + i),
                ok ? src + i : src, ok);
  };
  if (p_lo < p_hi) load_pair(0, p_lo);
  cp_async_commit();

  const int key0 = k_lo + warp * 16 + gid;  // keys of c0/c1 and c2/c3
  const uint32_t k_a = lane_addr_a(smem_u32(ks + warp * 16 * LD), LDB, lane);
  const uint32_t v_a = lane_addr_a(smem_u32(vs + warp * 16 * LD), LDB, lane);
  float acc_k[2 * OD][4], acc_v[2 * OD][4];
#pragma unroll
  for (int n = 0; n < 2 * OD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int p = p_lo; p < p_hi; ++p) {
    const int it = p - p_lo;
    cp_async_wait<0>();  // pair `p` (and K, V) has landed
    __syncthreads();     // ... for every thread; the other stage is free
    if (p + 1 < p_hi) load_pair((it + 1) % kStages, p + 1);
    cp_async_commit();
    const int qt = (t0 + p % nt) * kTile;
    const int stage = it % kStages;
    const uint32_t q_base = smem_u32(qs + stage * kTile * LD);
    const uint32_t do_base = smem_u32(dos + stage * kTile * LD);
    const uint32_t q_b = lane_addr_b(q_base, LDB, lane);
    const uint32_t do_b = lane_addr_b(do_base, LDB, lane);
    // the trans ldmatrix of the dims [16 OD part, 16 OD (part + 1))
    const uint32_t q_a = lane_addr_a(q_base, LDB, lane) + 32 * OD * part;
    const uint32_t do_a = lane_addr_a(do_base, LDB, lane) + 32 * OD * part;
    const float* lt = ls + stage * kTile;
    const float* dt = ds + stage * kTile;
    const bool edge =
        qt + kTile > Tq || k_lo + kTile > Tk ||
        (causal && (qt < k_lo + kTile - 1 ||
                    (window > 0 && qt + kTile - 1 - k_lo >= window)));

    // rolled: unrolled, the halves' loads are hoisted and spill at hd 128
    // (tools/flash_bwd_ab.py b-unrolled)
#pragma unroll 1
    for (int sub = 0; sub < kTile / SUB; ++sub) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries
      float st[SUB / 8][4], dpt[SUB / 8][4];
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        ldmatrix_x4(ak, k_a + 32 * kk);
        ldmatrix_x4(av, v_a + 32 * kk);
#pragma unroll
        for (int j = 0; j < SUB / 16; ++j) {
          const int off = (sub * SUB + 16 * j) * LDB + 32 * kk;
          uint32_t bq[4], bdo[4];
          ldmatrix_x4(bq, q_b + off);
          ldmatrix_x4(bdo, do_b + off);
          mma_16816(st[2 * j], ak, bq[0], bq[1]);
          mma_16816(st[2 * j + 1], ak, bq[2], bq[3]);
          mma_16816(dpt[2 * j], av, bdo[0], bdo[1]);
          mma_16816(dpt[2 * j + 1], av, bdo[2], bdo[3]);
        }
      }
      // P^T = exp2(S^T scale log2e - LSE log2e), dS^T = P^T (dP^T - D)
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = sub * SUB + 8 * n + 2 * tig + (e & 1);
          float p = exp2f(fmaf(st[n][e], scale_log2, -lt[c] * kLog2e));
          if (edge) {
            const int qi = qt + c;
            if (qi >= Tq ||
                !visible(qi, key0 + 8 * (e >> 1), Tk, causal, window))
              p = 0.f;
          }
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dt[c]);
        }
      }
      // dV += P^T dO, dK += dS^T Q: 16 queries a step, split hi + lo
#pragma unroll
      for (int j = 0; j < SUB / 16; ++j) {
        const int off = (sub * SUB + 16 * j) * LDB;
        pv_split<OD>(acc_v, st[2 * j], st[2 * j + 1], do_a + off);
        pv_split<OD>(acc_k, dpt[2 * j], dpt[2 * j + 1], q_a + off);
      }
    }
  }
  cp_async_wait<0>();

  const long long plane = (long long)B * Tk * KV * hd;  // one split's
#pragma unroll
  for (int n = 0; n < 2 * OD; ++n) {
    const int col = 16 * OD * part + 8 * n + 2 * tig;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Tk) continue;
      if (nsplit == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + b * sdk.b + key * sdk.t +
                                           g * sdk.h + col) =
            __floats2bfloat162_rn(acc_k[n][2 * r] * scale,
                                  acc_k[n][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + b * sdv.b + key * sdv.t +
                                           g * sdv.h + col) =
            __floats2bfloat162_rn(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
      } else {
        const long long at =
            split * plane + (((long long)b * Tk + key) * KV + g) * hd + col;
        *reinterpret_cast<float2*>(work + at) =
            make_float2(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
        *reinterpret_cast<float2*>(work + nsplit * plane + at) =
            make_float2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
      }
    }
  }
}

// Kernel C, nsplit > 1: dK = scale * sum of the splits' partials and dV =
// their sum, in split order, rounded to bf16 once; a thread an element
// pair of the (B, Tk, KV, hd) gradients
__global__ void __launch_bounds__(256)
    flash_bwd_reduce(const float* __restrict__ work, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides sdk, Strides sdv, int B,
                     int Tk, int KV, int hd, int nsplit, float scale) {
  const long long plane = (long long)B * Tk * KV * hd;
  const long long i =
      2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= plane) return;
  const int col = (int)(i % hd);
  const long long row = i / hd;  // (b, t, kv) flattened
  const int g = (int)(row % KV), t = (int)(row / KV % Tk);
  const int b = (int)(row / KV / Tk);
  float2 sk = make_float2(0.f, 0.f), sv = sk;
  for (int s = 0; s < nsplit; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(work + s * plane + i);
    const float2 c =
        *reinterpret_cast<const float2*>(work + (nsplit + s) * plane + i);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += c.x;
    sv.y += c.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + b * sdk.b + t * sdk.t + g * sdk.h +
                                     col) =
      __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  *reinterpret_cast<__nv_bfloat162*>(dv + b * sdv.b + t * sdv.t + g * sdv.h +
                                     col) = __floats2bfloat162_rn(sv.x, sv.y);
}

template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv,
           const long long* st, int B, int Tq, int Tk, int H, int KV, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const int group = H / KV, hdp = padded(hd);
  int e = 0;
  const size_t smem_dq = sizeof(float) * (size_t)(2 * kBQ + 2 * kBK) * hdp;
  if ((e = allow_smem(flash_bwd_dq<T, DPL>, smem_dq))) return e;
  flash_bwd_dq<T, DPL><<<dim3((Tq + kBQ - 1) / kBQ, H, B), kThreads, smem_dq,
                         stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dq, sq, sk, sv, sdo, sdq, Tq, Tk, H, group, hd, causal, window,
      scale);
  if ((e = (int)cudaGetLastError())) return e;

  const size_t smem_kv =
      sizeof(float) * ((size_t)(2 * kBK + 2 * kBQ) * hdp + 2 * kBQ * kBK);
  if ((e = allow_smem(flash_bwd_dkdv<T, DPL>, smem_kv))) return e;
  flash_bwd_dkdv<T, DPL><<<dim3((Tk + kBK - 1) / kBK, KV, B), kThreads,
                           smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dk, (T*)dv, sq, sk, sv, sdo, sdk, sdv, Tq, Tk, H, group, hd, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* dsum, void* dq,
                 void* dk, void* dv, const long long* st, int B, int Tq,
                 int Tk, int H, int KV, int hd, int causal, int window,
                 float scale, cudaStream_t stream) {
#define REPRO_FLASH_BWD(DPL)                                               \
  return launch<T, DPL>(q, k, v, dout, lse, dsum, dq, dk, dv, st, B, Tq,   \
                        Tk, H, KV, hd, causal, window, scale, stream)
  const int dpl = (hd + 31) / 32;
  if (dpl <= 1) REPRO_FLASH_BWD(1);
  if (dpl <= 2) REPRO_FLASH_BWD(2);
  if (dpl <= 4) REPRO_FLASH_BWD(4);
  REPRO_FLASH_BWD(8);
#undef REPRO_FLASH_BWD
}

template <int KD>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, float* dsum, void* dq, void* dk, void* dv,
              float* work, const long long* st, int B, int Tq, int Tk, int H,
              int KV, int hd, int causal, int window, float scale,
              int nsplit, int w, cudaStream_t stream) {
  constexpr int OD = KD < 8 ? KD : 8;  // hd > 128: two halves of the dims
  constexpr int kParts = KD / OD;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]},
      sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const int group = H / KV;
  if ((long long)B * nsplit * kParts > 65535)  // kernel B's grid z
    return (int)cudaErrorInvalidValue;
  int e = 0;
  const size_t smem_a =
      sizeof(bf16) * (16 * KD + kRowPad) * (2 + 2 * kStages) * kTile;
  if ((e = allow_smem(flash_bwd_dq_tc<KD>, smem_a))) return e;
  flash_bwd_dq_tc<KD><<<dim3((Tq + kTile - 1) / kTile, H, B), kTcThreads,
                        smem_a, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      dsum, (bf16*)dq, sq, sk, sv, sdo, sdq, Tq, Tk, group, hd, causal,
      window, scale, w);
  if ((e = (int)cudaGetLastError())) return e;

  const size_t smem_b = smem_a + sizeof(float) * 2 * kStages * kTile;
  if ((e = allow_smem(flash_bwd_dkdv_tc<KD, OD>, smem_b))) return e;
  flash_bwd_dkdv_tc<KD, OD>
      <<<dim3((Tk + kTile - 1) / kTile, KV, B * nsplit * kParts), kTcThreads,
         smem_b, stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          lse, dsum, (bf16*)dk, (bf16*)dv, work, sq, sk, sv, sdo, sdk, sdv, B,
          Tq, Tk, H, group, hd, causal, window, scale, nsplit, w);
  if ((e = (int)cudaGetLastError()) || nsplit == 1) return e;

  const long long pairs = (long long)B * Tk * KV * hd / 2;
  flash_bwd_reduce<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      work, (bf16*)dk, (bf16*)dv, sdk, sdv, B, Tk, KV, hd, nsplit, scale);
  return (int)cudaGetLastError();
}

// the widest cp.async (16, 8 or 4 bytes) that divides every row's bytes
// and start: the base pointers, the byte strides of q, k, v, dout and
// 2 * hd
int copy_width(const void* q, const void* k, const void* v, const void* dout,
               const long long* st, int hd) {
  uintptr_t al = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                 (uintptr_t)dout | (uintptr_t)(2 * hd);
  for (int i = 0; i < 12; ++i) al |= (uintptr_t)(2 * st[i]);
  return al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : al % 4 == 0 ? 4 : 0;
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, float* dsum, void* dq, void* dk, void* dv,
                float* work, const long long* st, int B, int Tq, int Tk,
                int H, int KV, int hd, int causal, int window, float scale,
                int nsplit, cudaStream_t stream) {
  const int w = copy_width(q, k, v, dout, st, hd);
  if (w == 0 || hd % 2) return (int)cudaErrorMisalignedAddress;
  if (nsplit < 1 || (nsplit > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const int steps = (hd + 15) / 16;
#define REPRO_FLASH_BWD_TC(KD)                                             \
  return launch_tc<KD>(q, k, v, dout, lse, dsum, dq, dk, dv, work, st, B,  \
                       Tq, Tk, H, KV, hd, causal, window, scale, nsplit, w, \
                       stream)
  if (steps <= 1) REPRO_FLASH_BWD_TC(1);
  if (steps <= 2) REPRO_FLASH_BWD_TC(2);
  if (steps <= 4) REPRO_FLASH_BWD_TC(4);
  if (steps <= 8) REPRO_FLASH_BWD_TC(8);
  REPRO_FLASH_BWD_TC(16);
#undef REPRO_FLASH_BWD_TC
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32 (the CUDA-core kernels), 1 = bf16 (the tensor-core
// kernels; q, k, v, dout, dq, dk, dv all of the one type). strides: host
// array of 21 int64 element strides, dims 0..2 of q, k, v, dout, dq, dk,
// dv in that order (dim 3 contiguous). lse: the forward's contiguous (B,
// H, Tq) f32 log-sum-exp; dsum: a (B, H, Tq) f32 workspace (D = rowsum(P
// * dP)). nsplit: bf16 only, the query splits of the dK / dV kernel
// (kernels/flash_attention.plan_bwd); with nsplit > 1, work is a (2,
// nsplit, B, Tk, KV, hd) f32 workspace (null otherwise). Requires hd <=
// 256 (bf16: even), H % KV == 0, B, Tq, Tk > 0.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, void* dsum,
                        void* dq, void* dk, void* dv, void* work,
                        const void* strides, int dtype, int B, int Tq, int Tk,
                        int H, int KV, int hd, int causal, int window,
                        int nsplit, float scale, void* stream) {
  const long long* st = (const long long*)strides;
  if (hd > 256 || hd < 1 || H % KV || B < 1 || Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return launch_bf16(q, k, v, dout, (const float*)lse, (float*)dsum, dq, dk,
                       dv, (float*)work, st, B, Tq, Tk, H, KV, hd, causal,
                       window, scale, nsplit, (cudaStream_t)stream);
  }
  return launch_dtype<float>(q, k, v, dout, (const float*)lse, (float*)dsum,
                             dq, dk, dv, st, B, Tq, Tk, H, KV, hd, causal,
                             window, scale, (cudaStream_t)stream);
}

}  // extern "C"
