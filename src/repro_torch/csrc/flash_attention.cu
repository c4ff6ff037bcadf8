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
// What bounds it on the H100: at the main-path shape (B=8, T=128, H=28,
// KV=4, hd=128, bf16) it moves ~8.4 MB (~2.5 us at 3.35 TB/s) and needs
// ~0.95 GFLOP of causal products (~1 us at the bf16 tensor-core peak), so
// the bound is bytes. This first kernel computes on the CUDA cores in f32
// (no wgmma), so it is compute-bound well above that floor.
//
// Design: one block per (16 query rows, head, batch); 4 warps, each owns 4
// rows. K/V tiles of 32 keys are staged to shared memory as f32 (K rows
// padded to hd+4 floats so 16-byte reads are conflict-free); a lane scores
// one key per tile, the warp reduces max/sum with shuffles, and each lane
// accumulates hd/32 output dims. Tiles entirely above the diagonal or
// outside the window are never loaded. Masked keys get probability 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr int kMaxDPL = 8;                  // hd <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
                                       T* __restrict__ o, Strides sq,
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
           const long long* st, int B, int Tq, int Tk, int H, int KV, int hd,
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
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, Tq, Tk, H,
      H / KV, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16. strides: host array of 12 int64 element
// strides, dims 0..2 of q, k, v, o in that order. Requires hd <= 256 and
// H % KV == 0.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const void* strides, int dtype, int B, int Tq, int Tk,
                    int H, int KV, int hd, int causal, int window, float scale,
                    void* stream) {
  const long long* st = (const long long*)strides;
  if (hd > 32 * kMaxDPL || H % KV) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, st, B, Tq, Tk, H, KV, hd, causal,
                                 window, scale, (cudaStream_t)stream);
  }
  return launch<float>(q, k, v, o, st, B, Tq, Tk, H, KV, hd, causal, window,
                       scale, (cudaStream_t)stream);
}

}  // extern "C"
