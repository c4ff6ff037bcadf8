// comq_panel: the intra-panel COMQ coordinate sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/comq_panel.py
// (_panel_call / _kernel, entry comq_panel_dq_pallas). Plain version:
// repro_torch.core.comq_hessian.panel_sweep_dq_ref.
//
// For t = 0..B-1 and every column j independently:
//   s_t   = s0[t, j] - sum_{k<t} h_bb[t, k] * dW[k, j]
//   q'    = clip(rint(s_t / (delta_j * h_tt) + q_tj), z_lo_j, z_hi_j)
//           (or clip(rint(q_tj)) when h_tt <= 1e-12)
//   dW[t, j] = (q' - q_tj) * delta_j
// and returns (q', dW), both (B, n) f32. A stack of E panels (one per
// expert: the JAX package's vmap of the panel call over the expert axis) is
// one launch with the expert as the grid's y index; each block offsets its
// pointers to its expert's operands and runs the single-panel code, so an
// expert's result is that of a single launch on its slices, bit for bit.
//
// What bounds it on the H100: traffic is ~2*B*n*4 bytes in and out (~78 MB
// at B=256, n=18944: ~23 us at 3.35 TB/s); the triangular products are
// B(B-1)/2 FMAs a column (~18 us at the f32 peak). Each column is also a
// B-step dependency chain (an IEEE division and a rounding a step), which
// sets a block's latency; columns are independent.
//
// Design: a blocked sweep. The B rows are cut into sub-panels of kSub rows.
// A block owns C columns of one expert's panel (C = 32, 16, 8 or 4: fewer
// when E * n is small, so that every SM gets a block) and 4 warps, and keeps the running s of all
// B rows of its columns in shared memory, loaded from s0 up front. Per
// sub-panel:
//  1. sequential: thread c < C walks its column's kSub steps with the
//     sub-panel's s, codes and reciprocal denominators in registers,
//     right-looking: after each step it subtracts
//     h_bb[u, t] * dW[t] from the later rows u of the sub-panel, so only
//     one FMA sits on the chain between two roundings;
//  2. trailing: all threads apply the rank-kSub update
//     s[rows after] -= h_bb[rows after, sub] . dW[sub], an f32 FMA product
//     blocked in registers (a thread: 4 columns x kSub dW values, one row
//     of h_bb at a time).
// The FMA count is unchanged; only ~B*kSub/2 of it stays on the chain.
// The column strip h_bb[sub.., sub] and the sub-panel's rows of qf stream
// through a cp.async ring (two sub-panels ahead below C = 32); h_bb's
// diagonal and the column parameters are loaded before the first step.
// The chain is the kernel's latency: each step's IEEE division and
// rounding sit on it. A branch-free fast pass replaces the division by the
// product with the reciprocal (taken before the chain) and rounds in two
// adds; where a lane's quotient came within ~10 ulps of a rounding
// boundary, the warp redoes the sub-panel with __fdiv_rn and rintf, so
// the codes are exactly those of IEEE division and round-half-even. The
// h_tt <= 1e-12 branch is kept and everything is f32 (no TF32). So a code
// differs from the plain version only where the two summation orders put
// s_t on the other side of a rounding boundary. The warps other than the
// chain's issue the copies and store the sub-panel's codes and dW, so the
// chain warp only computes. (Leaving the whole trailing update to those
// warps, behind named barriers, so the chain warp runs a sub-panel ahead,
// measured slower on the H100.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::cp_async;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_w;
using mma_bf16::cp_async_wait;
using mma_bf16::for_each_chunk;
using mma_bf16::smem_u32;

constexpr int kSub = 16;                       // rows a sub-panel
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kEps = 1e-12f;
constexpr size_t kSmemMax = 232448;            // a block's shared memory

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The tiling of a block of C columns: cp.async stages (3 below C = 32, so
// that the next strips load two sub-panels ahead; 2 at C = 32, so that
// three blocks fit an SM) and the strip row stride in floats (padded where
// a quarter-warp's float4 reads span several strip rows).
template <int C>
struct Tile {
  static constexpr int kStages = C >= 32 ? 2 : 3;
  static constexpr int kHld = C >= 16 ? kSub : kSub + 4;
  // shared memory, in floats: s (B x C), diag (B), dW and codes (kSub x C
  // each), then kStages stages of [strip (B x kHld), qf rows (kSub x C)]
  static __host__ __device__ int stage_floats(int B) {
    return B * kHld + kSub * C;
  }
  static __host__ __device__ int smem_floats(int B) {
    return B * C + round4(B) + 2 * kSub * C + kStages * stage_floats(B);
  }
};

// 1 / x within ~1 ulp (MUFU.RCP; no branch to a slow path)
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// rint(v) for |v| < 2^22 (round half to even, as rintf), in two adds; a
// larger |v| gives another value beyond 2^22, which the clamp to the grid
// maps to the same code
__device__ __forceinline__ float rint_small(float v) {
  constexpr float kMagic = 12582912.0f;        // 1.5 * 2^23
  return __fadd_rn(__fadd_rn(v, kMagic), -kMagic);
}

// Step t of a sub-panel's chain from its rounded value r: the clamped code
// (returned), its dW, and dW's share of the later rows' s (right-looking).
template <int kHld>
__device__ __forceinline__ float chain_step(int t, float r, float zl,
                                            float zh, float d,
                                            const float (&qg)[kSub],
                                            float (&dd)[kSub],
                                            float (&sr)[kSub],
                                            const float* hs) {
  const float qn = fminf(fmaxf(r, zl), zh);
  dd[t] = (qn - qg[t]) * d;
#pragma unroll
  for (int u = t + 1; u < kSub; ++u)
    sr[u] = fmaf(-hs[u * kHld + t], dd[t], sr[u]);
  return qn;
}

// wc / wh: cp.async widths (bytes) for rows of s0/qf and of h_bb
template <int C>
__global__ void __launch_bounds__(kThreads)
comq_panel_dq_kernel(const float* __restrict__ h_bb,
                     const float* __restrict__ s0,
                     const float* __restrict__ qf,
                     const float* __restrict__ delta,
                     const float* __restrict__ z_lo,
                     const float* __restrict__ z_hi,
                     const float* __restrict__ hdiag,
                     float* __restrict__ qf_out, float* __restrict__ dq_out,
                     int B, int n, int wc, int wh) {
  // this block's expert: every operand at its expert's offset
  {
    const size_t e = blockIdx.y;
    const size_t bn = (size_t)B * n;
    h_bb += e * B * B;
    s0 += e * bn;
    qf += e * bn;
    qf_out += e * bn;
    dq_out += e * bn;
    delta += e * n;
    z_lo += e * n;
    z_hi += e * n;
    hdiag += e * B;
  }
  using T = Tile<C>;
  constexpr int kHld = T::kHld, kStages = T::kStages;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);  // [B][C]
  float* diag = s + B * C;                     // [B]
  float* dws = diag + round4(B);               // [kSub][C]
  float* qns = dws + kSub * C;                 // [kSub][C] codes
  float* stage0 = qns + kSub * C;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * C;

  auto strip = [&](int p) {
    return stage0 + (p % kStages) * T::stage_floats(B);
  };
  auto qrows = [&](int p) { return strip(p) + B * kHld; };

  // the C columns of rows [0, rows) of a (., n) matrix from row r0
  auto load_cols = [&](float* dst, const float* src, int r0, int rows,
                       int t0, int nt) {
    const int fpc = wc / 4, cpr = C / fpc;
    for_each_chunk(rows, cpr, t0, nt, [&](int r, int c) {
      const int col = j0 + c * fpc;
      const bool v = col < n;
      cp_async_w(smem_u32(dst + r * C + c * fpc),
                 src + (size_t)(r0 + r) * n + (v ? col : 0), v, wc);
    });
  };
  const int n_sub = (B + kSub - 1) / kSub;
  // stage p: h_bb[st.., st..st+kSub) and qf rows [st, st+kSub); always
  // one commit group, empty past the last sub-panel
  auto load_stage = [&](int p, int t0, int nt) {
    if (p < n_sub) {
      const int st = p * kSub, rows = B - st;
      float* hs = strip(p);
      const int fpc = wh / 4;
      for_each_chunk(rows, kSub / fpc, t0, nt, [&](int r, int c) {
        const int col = st + c * fpc;
        const bool v = col < B;
        cp_async_w(smem_u32(hs + r * kHld + c * fpc),
                   h_bb + (size_t)(st + r) * B + (v ? col : 0), v, wh);
      });
      load_cols(qrows(p), qf, st, min(kSub, rows), t0, nt);
    }
    cp_async_commit();
  };

  // everything independent of the chain, up front
  load_cols(s, s0, 0, B, tid, kThreads);
  for (int i = tid; i < B; i += kThreads)
    cp_async<4>(smem_u32(diag + i), hdiag + i, true);
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) load_stage(p, tid, kThreads);
  const int j = j0 + tid;
  const bool live = tid < C && j < n;
  const float d = live ? delta[j] : 1.0f;
  const float zl = live ? z_lo[j] : 0.0f;
  const float zh = live ? z_hi[j] : 0.0f;
  const float d_live = live ? d : 0.0f;   // dead columns leave s unchanged
  constexpr unsigned kChainLanes = C >= 32 ? ~0u : (1u << C) - 1u;

  // trailing-update layout: 4 columns (cg) x rows rr, rr + rstep, ...
  constexpr int kGroups = C / 4;
  constexpr int kRowStep = kThreads / kGroups;
  const int cg = tid % kGroups, rr = tid / kGroups;

  for (int p = 0; p < n_sub; ++p) {
    const int st = p * kSub, rows = B - st;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage p landed; stage p - 1 is no longer read
    // the chain warp issues no copies: the other warps load ahead
    if (tid >= 32) load_stage(p + kStages - 1, tid - 32, kThreads - 32);
    const float* hs = strip(p);

    // 1. the sub-panel's chain, one thread a column. The fast pass takes
    // s / denom as s * (1 / denom): within ~3 ulps of the IEEE quotient,
    // so v = s / denom + qg rounds alike unless v lies within `margin`
    // (~10 ulps) of a half-integer. The pass has no branch; if any lane
    // came that close in any step, the warp redoes the sub-panel with
    // __fdiv_rn, so the codes are those of IEEE division.
    if (tid < C) {
      const float* qs = qrows(p);
      float sr[kSub], s_in[kSub], qg[kSub], rcp[kSub], dd[kSub], qn[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {   // loads and reciprocals first
        const bool in = t < rows;
        sr[t] = in ? s[(st + t) * C + tid] : 0.f;
        s_in[t] = sr[t];
        qg[t] = in ? qs[t * C + tid] : 0.f;
        const float hg = in ? diag[st + t] : 0.f;
        // 0 where h_tt <= 1e-12: then the code is rint(qg); computed
        // unconditionally and selected, so the loads pipeline
        const float r = rcp_approx(d * hg > 0.f ? d * hg : 1.0f);
        rcp[t] = hg > kEps ? r : 0.f;
      }
      bool near = false;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float v = rcp[t] != 0.f ? fmaf(sr[t], rcp[t], qg[t]) : qg[t];
        const float r = rint_small(v);
        const float margin = (fabsf(sr[t] * rcp[t]) + fabsf(v)) * 1.2e-6f;
        near |= !(fabsf(fabsf(v - r) - 0.5f) > margin);   // NaN: redo too
        qn[t] = chain_step<kHld>(t, r, zl, zh, d_live, qg, dd, sr, hs);
      }
      if (__any_sync(kChainLanes, near)) {
#pragma unroll
        for (int t = 0; t < kSub; ++t) sr[t] = s_in[t];
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
          const float hg = t < rows ? diag[st + t] : 0.f;
          const float den = d * hg > 0.f ? d * hg : 1.0f;
          const float v =
              rcp[t] != 0.f ? __fdiv_rn(sr[t], den) + qg[t] : qg[t];
          qn[t] = chain_step<kHld>(t, rintf(v), zl, zh, d_live, qg, dd, sr,
                                   hs);
        }
      }
      // results to shared memory; the other warps store them
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        dws[t * C + tid] = t < rows ? dd[t] : 0.f;
        qns[t * C + tid] = qn[t];
      }
    }
    __syncthreads();
    if (tid >= 32) {   // the sub-panel's codes and dW, coalesced
      for (int i = tid - 32; i < min(kSub, rows) * C; i += kThreads - 32) {
        const int t = i / C, c = i % C;
        if (j0 + c < n) {
          const size_t idx = (size_t)(st + t) * n + j0 + c;
          qf_out[idx] = qns[i];
          dq_out[idx] = dws[i];
        }
      }
    }

    // 2. rank-kSub update of the rows after the sub-panel
    if (rows > kSub) {
      float4 dw[kSub];
#pragma unroll
      for (int k = 0; k < kSub; ++k)
        dw[k] = *reinterpret_cast<const float4*>(dws + k * C + 4 * cg);
#pragma unroll 2
      for (int r = kSub + rr; r < rows; r += kRowStep) {
        float4* sp = reinterpret_cast<float4*>(s + (st + r) * C + 4 * cg);
        float4 a = *sp;
        const float* hr = hs + r * kHld;
#pragma unroll
        for (int k = 0; k < kSub; k += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hr + k);
          const float hk[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a.x = fmaf(-hk[i], dw[k + i].x, a.x);
            a.y = fmaf(-hk[i], dw[k + i].y, a.y);
            a.z = fmaf(-hk[i], dw[k + i].z, a.z);
            a.w = fmaf(-hk[i], dw[k + i].w, a.w);
          }
        }
        *sp = a;
      }
    }
  }
}

template <int C>
int launch(const float* h_bb, const float* s0, const float* qf,
           const float* delta, const float* z_lo, const float* z_hi,
           const float* hdiag, float* qf_out, float* dq_out, int E, int B,
           int n, int wc, int wh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Tile<C>::smem_floats(B);
  cudaError_t e = cudaFuncSetAttribute(
      comq_panel_dq_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + C - 1) / C, E);
  comq_panel_dq_kernel<C><<<grid, kThreads, smem, stream>>>(
      h_bb, s0, qf, delta, z_lo, z_hi, hdiag, qf_out, dq_out, B, n, wc, wh);
  return (int)cudaGetLastError();
}

size_t smem_bytes(int B, int C) {
  switch (C) {
    case 32: return sizeof(float) * (size_t)Tile<32>::smem_floats(B);
    case 16: return sizeof(float) * (size_t)Tile<16>::smem_floats(B);
    case 8: return sizeof(float) * (size_t)Tile<8>::smem_floats(B);
    default: return sizeof(float) * (size_t)Tile<4>::smem_floats(B);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The largest panel B a block's shared memory holds (at 4 columns a
// block, the least; 889 on the H100)
int comq_panel_max_b() {
  int b = 1;
  while (smem_bytes(b + 1, 4) <= kSmemMax) ++b;
  return b;
}

// Columns a block takes for E panels of n columns on n_sm SMs: the most
// (of 32, 16, 8, 4) that still gives every SM a block, else 4.
int comq_panel_cols(int n, int E, int n_sm) {
  for (int c = 32; c > 4; c /= 2)
    if ((long long)E * ((n + c - 1) / c) >= n_sm) return c;
  return 4;
}

// All pointers are f32 device buffers, E panels back to back: h_bb
// (E,B,B), s0/qf/qf_out/dq_out (E,B,n) row-major, delta/z_lo/z_hi (E,n),
// hdiag (E,B). E = 1 is a single panel.
int comq_panel_dq(const void* h_bb, const void* s0, const void* qf,
                  const void* delta, const void* z_lo, const void* z_hi,
                  const void* hdiag, void* qf_out, void* dq_out, int E, int B,
                  int n, int n_sm, void* stream) {
  if (E <= 0 || E > 65535 || B <= 0 || n <= 0 ||
      smem_bytes(B, 4) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where rows start on 16 bytes, else 4-byte ones (an
  // expert's operands then start on 16 bytes too)
  const int wc = (n % 4 == 0 && aligned16(s0) && aligned16(qf)) ? 16 : 4;
  const int wh = (B % 4 == 0 && kSub % 4 == 0 && aligned16(h_bb)) ? 16 : 4;
  const float* a[7] = {(const float*)h_bb, (const float*)s0,
                       (const float*)qf, (const float*)delta,
                       (const float*)z_lo, (const float*)z_hi,
                       (const float*)hdiag};
  float* qo = (float*)qf_out;
  float* dqo = (float*)dq_out;
  const cudaStream_t st = (cudaStream_t)stream;
  // fewer columns where a large B would not fit one block's shared memory
  int cols = comq_panel_cols(n, E, n_sm);
  while (cols > 4 && smem_bytes(B, cols) > kSmemMax) cols /= 2;
  switch (cols) {
    case 32:
      return launch<32>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], qo, dqo, E,
                        B, n, wc, wh, st);
    case 16:
      return launch<16>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], qo, dqo, E,
                        B, n, wc, wh, st);
    case 8:
      return launch<8>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], qo, dqo, E,
                       B, n, wc, wh, st);
    default:
      return launch<4>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], qo, dqo, E,
                       B, n, wc, wh, st);
  }
}

}  // extern "C"
