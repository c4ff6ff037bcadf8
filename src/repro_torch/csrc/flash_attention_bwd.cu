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
// A simple design on CUDA cores, f32 throughout (bf16 inputs are widened
// as they are staged; bf16 outputs are rounded once at the end):
// - dq kernel: one block per (batch, query head, 16 query rows). A first
//   pass over the 32-key tiles the rows can see sums D (written for the
//   dkdv kernel), a second forms dS and dQ; a lane scores one key of the
//   tile, a warp owns 4 rows and their dQ (hd spread over the lanes).
// - dkdv kernel (after it on the stream): one block per (batch, kv head,
//   32 keys), looping over the group's query heads and the 16-row query
//   tiles that can see the keys; the block's dK / dV stay in registers (a
//   warp owns 8 keys), so a GQA group is summed in the kernel, with no
//   K/V expansion in memory.
// Neither writes a location another block writes (no atomics), so the
// gradients are bit-for-bit deterministic run to run.
//
// Masks as the forward's: key s is visible from query t when s < Tk and,
// if causal, s <= t and (window <= 0 or t - s < window). Tq and Tk are
// free (the VLM's cross layer; non-causal), T need not divide the tiles,
// hd <= 256 (padded to a multiple of 4 in shared memory).
//
// What bounds it on the H100: at the training shape (B=8, T=128, 28/4
// heads, hd 128, causal) it reads q, k, v, dO and writes dQ, dK, dV
// (~7 x 2 MB in bf16) and does ~5 causal products of the forward's size
// (the dq kernel's D pass adds two); on CUDA cores at f32 the products
// bound it (tensor cores are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16 (q, k, v, dout, dq, dk, dv all of it).
// strides: host array of 21 int64 element strides, dims 0..2 of q, k, v,
// dout, dq, dk, dv in that order (dim 3 contiguous). lse: the forward's
// contiguous (B, H, Tq) f32 log-sum-exp; dsum: a (B, H, Tq) f32 workspace
// (D = rowsum(P * dP)). Requires hd <= 256, H % KV == 0, B, Tq, Tk > 0.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, void* dsum,
                        void* dq, void* dk, void* dv, const void* strides,
                        int dtype, int B, int Tq, int Tk, int H, int KV,
                        int hd, int causal, int window, float scale,
                        void* stream) {
  const long long* st = (const long long*)strides;
  if (hd > 256 || hd < 1 || H % KV || B < 1 || Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return launch_dtype<__nv_bfloat16>(
        q, k, v, dout, (const float*)lse, (float*)dsum, dq, dk, dv, st, B,
        Tq, Tk, H, KV, hd, causal, window, scale, (cudaStream_t)stream);
  }
  return launch_dtype<float>(q, k, v, dout, (const float*)lse, (float*)dsum,
                             dq, dk, dv, st, B, Tq, Tk, H, KV, hd, causal,
                             window, scale, (cudaStream_t)stream);
}

}  // extern "C"
