// quant_matmul: dequant-fused GEMM over COMQ's packed codes, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py
// (quant_matmul_pallas). Plain version:
// repro_torch.kernels.quant_matmul.quant_matmul_plain (unpack_codes, then
// the f32 product of kernels/ref.quant_matmul_ref).
//
//   Y[m, n] = acc[m, n] * scale[n] + rowsum[m] * (scale[n] * z[n])
//   acc[m, n] = sum_k X[m, k] * u[k, n],  rowsum[m] = sum_k X[m, k]
//
// X (M, K) f32; codes (K, N/cpb) uint8 packed along N: cpb 1 (one code a
// byte), 2 (low nibble first) or 4 (2-bit fields, lowest bits first); scale
// and z (N,) f32; Y (M, N) f32. M, N and K may be ragged.
//
// Input precision: plain f32 FMA on the CUDA cores (codes are exact small
// integers in f32). The TPU kernel cast X to bf16 for the MXU; this one
// does not, so it agrees with the f32 plain version to summation order.
//
// What bounds it on the H100: on the decode path M = batch (8), and the
// codes dominate the traffic (K*N/cpb bytes: ~34 MB for a 3584x18944
// 4-bit projection, ~10 us at 3.35 TB/s); the f32 products (2*M*K*N) are
// about as costly at the f32 peak (~16 us at 67 TFLOP/s).
//
// Design: codes are unpacked in registers. A block of 8 warps owns 32 code
// bytes along N (one per lane) and 8 rows of X; the warps split its K range,
// X rows are staged through shared memory in chunks of 256 k, and the warps'
// partial sums are reduced in shared memory. When the (N, M) tiles alone
// would not fill the card, K is also split across blocks (grid z) into an
// f32 workspace; a second small kernel sums the splits and applies scale and
// zero-point in the epilogue.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMT = 8;      // X rows per block
constexpr int kWarps = 8;
constexpr int kKT = 256;    // k rows of X staged per chunk

template <int CPB>
__global__ void __launch_bounds__(kWarps * 32)
qmm_partial_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                   float* __restrict__ part, float* __restrict__ part_rs,
                   int M, int K, int NB, int kc) {
  constexpr int kBits = 8 / CPB;
  constexpr unsigned kMask = (1u << kBits) - 1u;
  __shared__ __align__(16) float xs[kKT][kMT];
  __shared__ float red[kWarps][kMT][32 * CPB];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int jb = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * kMT;
  const int k_begin = blockIdx.z * kc;
  const int k_end = min(K, k_begin + kc);
  const int N = NB * CPB;
  const bool rowsum = blockIdx.x == 0;

  float acc[kMT][CPB];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < CPB; ++c) acc[m][c] = 0.f;
  float rs = 0.f;

  for (int kk = k_begin; kk < k_end; kk += kKT) {
    const int rows = min(kKT, k_end - kk);
    __syncthreads();
    for (int i = tid; i < kKT * kMT; i += kWarps * 32) {
      const int mm = i / kKT, r = i % kKT;
      xs[r][mm] = (r < rows && m0 + mm < M)
                      ? x[(size_t)(m0 + mm) * K + kk + r]
                      : 0.f;
    }
    __syncthreads();
    if (jb < NB) {
      for (int r = warp; r < rows; r += kWarps) {
        const unsigned byte = codes[(size_t)(kk + r) * NB + jb];
        const float4 xa = *reinterpret_cast<const float4*>(&xs[r][0]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[r][4]);
        const float xv[kMT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int c = 0; c < CPB; ++c) {
          const float u = (float)((byte >> (c * kBits)) & kMask);
#pragma unroll
          for (int m = 0; m < kMT; ++m) acc[m][c] = fmaf(xv[m], u, acc[m][c]);
        }
      }
    }
    if (rowsum && tid < kMT) {
      for (int r = 0; r < rows; ++r) rs += xs[r][tid];
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < CPB; ++c) red[warp][m][lane * CPB + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < kMT * 32 * CPB; i += kWarps * 32) {
    const int m = i / (32 * CPB), col = i % (32 * CPB);
    const int n = blockIdx.x * 32 * CPB + col;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][col];
    if (m0 + m < M && n < N) {
      part[((size_t)blockIdx.z * M + m0 + m) * N + n] = s;
    }
  }
  if (rowsum && tid < kMT && m0 + tid < M) {
    part_rs[(size_t)blockIdx.z * M + m0 + tid] = rs;
  }
}

__global__ void qmm_epilogue_kernel(const float* __restrict__ part,
                                    const float* __restrict__ part_rs,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ z,
                                    float* __restrict__ y, int M, int N,
                                    int ksplit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (n >= N) return;
  float acc = 0.f, rs = 0.f;
  for (int s = 0; s < ksplit; ++s) {
    acc += part[((size_t)s * M + m) * N + n];
    rs += part_rs[(size_t)s * M + m];
  }
  const float sc = scale[n];
  y[(size_t)m * N + n] = acc * sc + rs * (sc * z[n]);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M,K) f32, codes (K,NB) uint8 with N = NB*cpb, scale/z (N,) f32,
// y (M,N) f32; part (ksplit,M,N) and part_rs (ksplit,M) f32 workspaces;
// each split covers kc consecutive k rows.
int quant_matmul(const void* x, const void* codes, const void* scale,
                 const void* z, void* y, void* part, void* part_rs, int M,
                 int K, int NB, int cpb, int ksplit, int kc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((NB + 31) / 32, (M + kMT - 1) / kMT, ksplit);
  const dim3 block(kWarps * 32);
  const float* xf = (const float*)x;
  const uint8_t* cu = (const uint8_t*)codes;
  float* pf = (float*)part;
  float* prs = (float*)part_rs;
  switch (cpb) {
    case 1:
      qmm_partial_kernel<1><<<grid, block, 0, st>>>(xf, cu, pf, prs, M, K, NB,
                                                     kc);
      break;
    case 2:
      qmm_partial_kernel<2><<<grid, block, 0, st>>>(xf, cu, pf, prs, M, K, NB,
                                                     kc);
      break;
    case 4:
      qmm_partial_kernel<4><<<grid, block, 0, st>>>(xf, cu, pf, prs, M, K, NB,
                                                     kc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int N = NB * cpb;
  const dim3 egrid((N + 255) / 256, M);
  qmm_epilogue_kernel<<<egrid, 256, 0, st>>>(pf, prs, (const float*)scale,
                                             (const float*)z, (float*)y, M, N,
                                             ksplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
