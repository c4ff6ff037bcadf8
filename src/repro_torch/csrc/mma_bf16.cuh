// Warp-level bf16 tensor-core and cp.async helpers shared by the kernels
// (flash_attention.cu, paged_attention.cu, quant_matmul.cu; comq_panel.cu
// uses the copies only), for Hopper (sm_90a).
//
// - cp.async: asynchronous global -> shared copies of 16, 8 or 4 bytes,
//   zero-filled when the source row is out of range, grouped and waited on
//   by commit_group / wait_group (a ring of shared-memory stages).
// - ldmatrix: four 8x8 bf16 tiles from shared memory into mma fragments,
//   plain (A from row-major Q or P, B from row-major K) or transposed
//   (B from row-major V).
// - mma.sync.m16n8k16: bf16 A (16x16) x bf16 B (16x8), f32 accumulate.
//   Fragment layout, with gid = lane / 4 and tig = lane % 4:
//     A a0 (row gid, cols 2tig..+1), a1 (row gid+8, same cols),
//       a2 (row gid, cols 2tig+8..+9), a3 (row gid+8, cols 2tig+8..+9);
//     B b0 (rows 2tig..+1, col gid), b1 (rows 2tig+8..+9, col gid);
//     C c0, c1 (row gid, cols 2tig..+1), c2, c3 (row gid+8, same cols).
//   So the C fragments of two adjacent 8-column tiles of S are the A
//   fragment of P for a 16-deep step of P.V, with no data movement.
// - split-P: p = hi + lo with hi = bf16(p) and lo = bf16(p - hi), so two
//   bf16 mmas carry about 16 significant bits of an f32 probability.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W bytes from src to the shared address dst; with `valid` false the W
// bytes are zero-filled and nothing is read from src.
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? W : 0;
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(W), "r"(n));
  }
}

// the same with the width chosen at run time (uniform across the block)
__device__ __forceinline__ void cp_async_w(uint32_t dst, const void* src,
                                           bool valid, int w) {
  if (w == 16) {
    cp_async<16>(dst, src, valid);
  } else if (w == 8) {
    cp_async<8>(dst, src, valid);
  } else {
    cp_async<4>(dst, src, valid);
  }
}

// f(r, c) for chunks tid, tid + nthreads, ... of an n_rows x cpr block
// of row chunks taken row-major (row r, chunk c), stepped without a divide
template <class F>
__device__ __forceinline__ void for_each_chunk(int n_rows, int cpr, int tid,
                                               int nthreads, F&& f) {
  const int dr = nthreads / cpr, dc = nthreads % cpr;
  for (int r = tid / cpr, c = tid % cpr; r < n_rows;) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b (m16n8k16, bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16 pair, lo = bf16 pair of the remainders; x0 goes
// to the low half (the lower column of a fragment register)
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits_of(h);
  lo = bits_of(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// reductions over the four lanes (a quad) that hold one fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 1));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 1);
  return v + __shfl_xor_sync(~0u, v, 2);
}

// The online-softmax step of one warp's 16-row fragment: s holds this
// thread's scores of NT 8-key tiles (log2 units, -inf where masked) for
// rows gid (elements 0, 1) and gid + 8 (elements 2, 3); m and l are the
// two rows' running max and this thread's share of their running sums.
// Replaces s by exp2(s - m_new) and sets corr, the factors that rescale
// the rows' accumulators.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
    mx = quad_max(mx);
    const float base = mx == -INFINITY ? 0.f : mx;  // no live key yet
    corr[r] = exp2f(m[r] - base);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[i][2 * r] = exp2f(s[i][2 * r] - base);
      s[i][2 * r + 1] = exp2f(s[i][2 * r + 1] - base);
      sum += s[i][2 * r] + s[i][2 * r + 1];
    }
    m[r] = mx;
    l[r] = l[r] * corr[r] + sum;
  }
}

// Shared-memory addresses each lane hands ldmatrix for a 16x16 tile whose
// top-left element is at `base` (row stride ld_bytes):
// - as an A fragment (Q) or the B fragment of a transposed x4 (V): rows
//   lane % 8 + 8 * (lane / 8 % 2), cols 8 * (lane / 16);
// - as the B fragments of two 8-row tiles (K rows = keys): rows
//   lane % 8 + 8 * (lane / 16), cols 8 * (lane / 8 % 2).
__device__ __forceinline__ uint32_t lane_addr_a(uint32_t base, int ld_bytes,
                                                int lane) {
  return base + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld_bytes +
         16 * (lane >> 4);
}
__device__ __forceinline__ uint32_t lane_addr_b(uint32_t base, int ld_bytes,
                                                int lane) {
  return base + ((lane & 7) + 8 * (lane >> 4)) * ld_bytes +
         16 * ((lane >> 3) & 1);
}

// acc += P . V over one 16-key step, P split into bf16 hi + lo: p0 / p1
// are the (probability) C fragments of keys 0-7 / 8-15 of the step, and
// v_lane is this lane's lane_addr_a of the step's V rows at dim 0; the
// 2 * ND2 accumulator tiles cover dims 0 .. 16 * ND2 - 1.
template <int ND2>
__device__ __forceinline__ void pv_split(float (&acc)[2 * ND2][4],
                                         const float (&p0)[4],
                                         const float (&p1)[4],
                                         uint32_t v_lane) {
  uint32_t hi[4], lo[4];
  split_pack(p0[0], p0[1], hi[0], lo[0]);
  split_pack(p0[2], p0[3], hi[1], lo[1]);
  split_pack(p1[0], p1[1], hi[2], lo[2]);
  split_pack(p1[2], p1[3], hi[3], lo[3]);
  // V fragments one step ahead of the mmas; the two mmas into one
  // accumulator tile are not issued back to back
  uint32_t b[2][4];
  ldmatrix_x4_trans(b[0], v_lane);
#pragma unroll
  for (int n = 0; n < ND2; ++n) {
    if (n + 1 < ND2) ldmatrix_x4_trans(b[(n + 1) & 1], v_lane + 32 * (n + 1));
    const uint32_t(&bn)[4] = b[n & 1];
    mma_16816(acc[2 * n], hi, bn[0], bn[1]);
    mma_16816(acc[2 * n + 1], hi, bn[2], bn[3]);
    mma_16816(acc[2 * n], lo, bn[0], bn[1]);
    mma_16816(acc[2 * n + 1], lo, bn[2], bn[3]);
  }
}

}  // namespace mma_bf16
