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
// and returns (q', dW), both (B, n) f32.
//
// What bounds it on the H100: the rows t of one column form a B-step
// dependency chain, but columns are independent. Traffic is ~2*B*n*4 bytes
// in and out (~78 MB at B=256, n=18944: ~23 us at 3.35 TB/s); the
// triangular products are B(B-1)/2 FMAs per column (~18 us of f32 peak).
// In practice the per-column chain and shared-memory reads bound it.
//
// Design: one thread owns one column for all B steps, 32 columns (one warp)
// per block, one launch per panel per sweep. The TPU pinned H[blk,blk] and
// the whole panel in ~1 MiB of VMEM; a Hopper block has 227 KB of shared
// memory and h_bb alone is 256 KiB at B=256, so h_bb is streamed one row
// per step from L2 into shared memory (a broadcast read for the warp), and
// only the column's dW history (B floats per column, 32 KiB per block at
// B=256) lives in shared memory. Four partial sums break the FMA chain.
// Division is IEEE (no fast math) and rounding is rintf (half to even), so
// a code differs from the plain version only where the two summation orders
// put s_t on the other side of a rounding boundary.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;
constexpr float kEps = 1e-12f;

__global__ void comq_panel_dq_kernel(const float* __restrict__ h_bb,
                                     const float* __restrict__ s0,
                                     const float* __restrict__ qf,
                                     const float* __restrict__ delta,
                                     const float* __restrict__ z_lo,
                                     const float* __restrict__ z_hi,
                                     const float* __restrict__ hdiag,
                                     float* __restrict__ qf_out,
                                     float* __restrict__ dq_out,
                                     int B, int n) {
  extern __shared__ float4 smem4[];
  float* hrow = reinterpret_cast<float*>(smem4);          // [B]
  float* du = hrow + B;                                    // [B][kCols]
  const int c = threadIdx.x;
  const int j = blockIdx.x * kCols + c;
  const bool live = j < n;
  const float d = live ? delta[j] : 1.0f;
  const float zl = live ? z_lo[j] : 0.0f;
  const float zh = live ? z_hi[j] : 0.0f;

  for (int t = 0; t < B; ++t) {
    // stage the first t entries of row t of h_bb (the rest multiply zeros)
    const float* hsrc = h_bb + (size_t)t * B;
    for (int k = c; k < t; k += kCols) hrow[k] = hsrc[k];
    __syncthreads();
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    const float* dc = du + c;
    int k = 0;
    for (; k + 4 <= t; k += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hrow + k);
      a0 = fmaf(h4.x, dc[(k + 0) * kCols], a0);
      a1 = fmaf(h4.y, dc[(k + 1) * kCols], a1);
      a2 = fmaf(h4.z, dc[(k + 2) * kCols], a2);
      a3 = fmaf(h4.w, dc[(k + 3) * kCols], a3);
    }
    for (; k < t; ++k) a0 = fmaf(hrow[k], dc[k * kCols], a0);
    if (live) {
      const size_t idx = (size_t)t * n + j;
      const float qg = qf[idx];
      const float hg = hdiag[t];
      const float st = s0[idx] - ((a0 + a1) + (a2 + a3));
      const float denom = d * hg;
      const float ratio = __fdiv_rn(st, denom > 0.f ? denom : 1.0f);
      float qn;
      if (hg > kEps) {
        qn = fminf(fmaxf(rintf(ratio + qg), zl), zh);
      } else {
        qn = fminf(fmaxf(rintf(qg), zl), zh);
      }
      const float dd = (qn - qg) * d;
      du[t * kCols + c] = dd;
      qf_out[idx] = qn;
      dq_out[idx] = dd;
    } else {
      du[t * kCols + c] = 0.f;
    }
    __syncthreads();  // hrow is rewritten next step
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are f32 device buffers: h_bb (B,B), s0/qf/qf_out/dq_out
// (B,n) row-major, delta/z_lo/z_hi (n,), hdiag (B,).
int comq_panel_dq(const void* h_bb, const void* s0, const void* qf,
                  const void* delta, const void* z_lo, const void* z_hi,
                  const void* hdiag, void* qf_out, void* dq_out, int B, int n,
                  void* stream) {
  const size_t smem = sizeof(float) * (size_t)B * (kCols + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        comq_panel_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + kCols - 1) / kCols);
  comq_panel_dq_kernel<<<grid, kCols, smem, (cudaStream_t)stream>>>(
      (const float*)h_bb, (const float*)s0, (const float*)qf,
      (const float*)delta, (const float*)z_lo, (const float*)z_hi,
      (const float*)hdiag, (float*)qf_out, (float*)dq_out, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
