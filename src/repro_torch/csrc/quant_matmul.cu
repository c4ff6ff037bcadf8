// quant_matmul: dequant-fused GEMM over COMQ's packed codes, for Hopper
// (sm_90a), on the bf16 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py
// (quant_matmul_pallas). Plain version:
// repro_torch.kernels.quant_matmul.quant_matmul_plain (unpack_codes, then
// the f32 product of kernels/ref.quant_matmul_ref).
//
//   Y[m, n] = acc[m, n] * scale[n] + rowsum[m] * (scale[n] * z[n])
//   acc[m, n] = sum_k X[m, k] * u[k, n],  rowsum[m] = sum_k X[m, k]
//
// X (M, K) f32 or bf16; codes (K, N/cpb) uint8 packed along N: cpb 1 (one
// code a byte), 2 (low nibble first) or 4 (2-bit fields, lowest bits
// first); scale and z (N,) f32; Y (M, N) f32. M, N and K may be ragged.
//
// Input precision: the codes 0..255 are exact in bf16. An f32 X is first
// split (qmm_split_x_kernel, once a call) into three bf16 planes, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which carry x to
// ~2^-24; each plane goes through the tensor cores (three mmas a step), so
// every product is exact and the sums are f32: kernel and f32 plain
// version differ only in summation order. (Two planes, ~16 bits of x, held
// the kernel tolerance but moved the f32 decode logits of the random-init
// model past chip_smoke's gate; the TPU kernel rounds X to bf16.) A bf16 X
// is exact in one plane. rowsum is summed in f32: by the split kernel from
// the f32 X (in chunks of 1024 k, added in order), or in the kernel from
// the bf16 X.
//
// What bounds it on the H100: on the decode path M = batch (8) and the
// codes dominate the traffic (K*N/cpb bytes: ~34 MB for a 3584x18944
// 4-bit projection, ~10 us at 3.35 TB/s), far above the bf16 products
// (2*M*K*N, ~1 us at 989 TFLOP/s). At prefill-sized M (1024) the products
// bound it (~0.14 ms a 3584x18944 call at the bf16 peak; three times the
// mma work with three planes).
//
// Design: mma.sync m16n8k16 (bf16, f32 accumulate) computing Y^T = U^T X^T,
// so the codes fill the 16-row A operand and X is the 8-wide B operand.
// The sum over k accepts any order both operands share, so in each 16-deep
// step lane (gid, tig) takes k = 4*tig .. 4*tig + 3: its X fragment is one
// 8-byte read of row gid of each plane, and its code fragment is four
// 32-bit words (those k rows, bytes 4*gid .. 4*gid + 3 of the warp's
// 32-byte strip) that byte_perm pairs along k, and masks widen into bf16
// as 128 + u, less 128 (exact). A word holds 4*cpb codes = 2*cpb 16-row
// tiles of two rows each; the rows are assigned so that a lane's outputs
// are the 4*cpb consecutive n of its own word. Codes (rows swizzled in
// 16-byte chunks, so a word read is free of bank conflicts) and X planes
// stream through a cp.async ring (16-byte chunks where the rows allow;
// zero-filled past the edges): below M = 64 a block holds 4 warps side by
// side along N (128 code bytes) and 8 rows of X (one m tile; a larger M
// takes more row tiles) with 4 stages of 64 k rows; for M >= 64 a block
// of 8 warps takes 128 code bytes x 128 rows (64 at cpb 4) with 3 stages
// of 32 k rows. Where the (N, M) tiles do not fill the card, K is split
// across blocks (grid z, about four blocks an SM) into an f32 workspace
// and a second kernel sums the splits in split order (the result does not
// depend on the order blocks finish in); otherwise scale and zero-point
// are applied in the epilogue of the same kernel. `make_plan` makes these
// choices for a call; the wrapper only allocates and launches.
// (A variant where the last block of a tile sums its splits, saving the
// launch, was twice as slow at M = 8: one block a tile reduces serially.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::bits_of;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_w;
using mma_bf16::cp_async_wait;
using mma_bf16::for_each_chunk;
using mma_bf16::mma_16816;
using mma_bf16::quad_sum;
using mma_bf16::smem_u32;

using bf16 = __nv_bfloat16;

template <int MT_, int WM_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int MT = MT_;          // 8-row m tiles a warp
  static constexpr int WN = 4;            // warps along N (32 code bytes each)
  static constexpr int WM = WM_;          // warps along M
  static constexpr int BK = BK_;          // k rows a stage
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WN * WM;
  static constexpr int BNB = 32 * WN;     // code bytes a block (a code row)
  static constexpr int BM = 8 * MT * WM;  // rows of X a block
  // X plane rows in shared memory are padded by 16 bf16, so the lanes of
  // one 8-byte fragment read hit distinct banks
  static constexpr int XROW = (BK + 16) * 2;
};
// the configurations `make_plan` picks from: M < 64, and M >= 64
using Cfg8 = Cfg<1, 1, 64, 4>;
using CfgBig = Cfg<8, 2, 32, 3>;
using CfgBig4 = Cfg<4, 2, 32, 3>;   // cpb 4: 8 tiles a word
static_assert(Cfg8::BNB == CfgBig::BNB && CfgBig4::BNB == CfgBig::BNB &&
                  CfgBig4::BK == CfgBig::BK,
              "make_plan assumes one tile width and one stage depth at M >= 64");

template <class CF, int NP>
__host__ __device__ constexpr int stage_bytes() {
  return CF::BK * CF::BNB + NP * CF::BM * CF::XROW;
}

// Code rows are stored swizzled: the 16-byte chunk c of row r sits at
// chunk c ^ 2 * (r / 4 % 4), so the four k rows a quad of lanes reads
// (4 * tig + i) fall in four different 32-byte pairs of chunks: the 32
// lanes of one word read hit 32 banks.
__device__ __forceinline__ int code_off(int r, int byte) {
  return r * 128 + (((byte >> 4) ^ (2 * ((r >> 2) & 3))) << 4) + (byte & 15);
}

// w bytes from src to dst: cp.async for 4/8/16, plain loads for 1/2
// (rows whose width allows nothing wider); zero-filled when !valid
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           bool valid, int w) {
  if (w >= 4) {
    cp_async_w(smem_u32(dst), src, valid, w);
  } else if (w == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : 0;
  } else {
    *dst = valid ? *src : 0;
  }
}

// (128 + u0, 128 + u1) as a bf16 pair -> (u0, u1), exact
__device__ __forceinline__ uint32_t less128(uint32_t v) {
  const uint32_t c128 = 0x43004300u;
  return bits_of(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                         *reinterpret_cast<const __nv_bfloat162*>(&c128)));
}

// byte b of x and byte b of y into bytes (0, 1) and (2, 3)
__device__ __forceinline__ uint32_t pair_bytes(uint32_t x, uint32_t y,
                                               int b) {
  return __byte_perm(x, y, b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12));
}

// byte b of w as an exact f32
__device__ __forceinline__ float byte_f32(uint32_t w, int b) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | b)) -
         8388608.f;
}

// The A fragment of tile T from the words of k = 4tig .. 4tig + 3: rows
// gid / gid + 8 hold codes 2T / 2T + 1 of the lane's word (code c of a
// word is field c % cpb of byte c / cpb).
template <int CPB>
__device__ __forceinline__ void unpack_tile(const uint32_t (&w)[4], int T,
                                            uint32_t (&a)[4]) {
  if constexpr (CPB == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {        // k pair (w0, w1) or (w2, w3)
#pragma unroll
      for (int r = 0; r < 2; ++r) {      // row gid or gid + 8
        const int b = 2 * T + r;
        a[2 * h + r] = bits_of(__floats2bfloat162_rn(
            byte_f32(w[2 * h], b), byte_f32(w[2 * h + 1], b)));
      }
    }
  } else {
    constexpr int kBits = 8 / CPB;
    constexpr uint32_t kMask = ((1u << kBits) - 1u) * 0x00010001u;
    const int b = (2 * T) / CPB;
    const int f = (2 * T) % CPB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t t = pair_bytes(w[2 * h], w[2 * h + 1], b);
      a[2 * h] = less128(((t >> (f * kBits)) & kMask) | 0x43004300u);
      a[2 * h + 1] =
          less128(((t >> ((f + 1) * kBits)) & kMask) | 0x43004300u);
    }
  }
}

// f32 X -> three bf16 planes hi, mid, lo (x = hi + mid + lo to ~2^-24 of
// x: each plane holds the bf16 rounding of what the previous ones left)
// and the f32 sums of x over chunks of kSplitChunk k: block (c, m) takes
// chunk c of row m and writes its sum to rs_part[m * gridDim.x + c].
constexpr int kSplitChunk = 1024;

__global__ void __launch_bounds__(256)
qmm_split_x_kernel(const float* __restrict__ x, bf16* __restrict__ planes,
                   float* __restrict__ rs_part, int M, int K) {
  __shared__ float red[8];
  const int m = blockIdx.y;
  const int k0 = blockIdx.x * kSplitChunk;
  const int k1 = min(K, k0 + kSplitChunk);
  const size_t row = (size_t)m * K, plane = (size_t)M * K;
  float acc = 0.f;
  for (int k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
    const float v = x[row + k];
    const bf16 h = __float2bfloat16_rn(v);
    const float r1 = v - __bfloat162float(h);
    const bf16 md = __float2bfloat16_rn(r1);
    planes[row + k] = h;
    planes[plane + row + k] = md;
    planes[2 * plane + row + k] =
        __float2bfloat16_rn(r1 - __bfloat162float(md));
    acc += v;
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += red[w];
    rs_part[(size_t)m * gridDim.x + blockIdx.x] = t;
  }
}

// sum_k x[m, k] from the split kernel's chunk sums, in chunk order
__device__ __forceinline__ float row_sum(const float* __restrict__ rs_part,
                                         int m, int n_chunks) {
  float t = 0.f;
  for (int c = 0; c < n_chunks; ++c)
    t += __ldg(rs_part + (size_t)m * n_chunks + c);
  return t;
}

// One launch: blocks (N tiles, M tiles, K splits) over NP bf16 planes of X
// (plane p at xp + p * M * K): NP = 1 is a bf16 X, NP = 3 the split of an
// f32 X, whose row sums come as the split kernel's n_chunks chunk sums a
// row in `rowsum`; with NP = 1 the block sums its own rows. With part ==
// nullptr (one split) the epilogue applies scale and zero-point into y;
// otherwise the partial sums go to part (ksplit, M, N) and, for NP = 1,
// the rowsums to part_rs (ksplit, M). kc = k rows a split (a multiple of
// BK); wx / wc = copy widths in bytes for rows of the planes and codes.
template <int CPB, int NP, class CF>
__global__ void __launch_bounds__(CF::THREADS)
qmm_kernel(const bf16* __restrict__ xp, const float* __restrict__ rowsum,
           const uint8_t* __restrict__ codes,
           const float* __restrict__ scale, const float* __restrict__ z,
           float* __restrict__ y, float* __restrict__ part,
           float* __restrict__ part_rs, int M, int K, int NB, int kc, int wx,
           int wc, int n_chunks) {
  constexpr int CBYTES = CF::BK * CF::BNB;
  constexpr int STAGE = stage_bytes<CF, NP>();
  constexpr int NT = 2 * CPB;             // 16-row tiles a word
  constexpr int MT = CF::MT;
  extern __shared__ float4 smem4[];
  __shared__ float rs_s[CF::BM];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wn = warp % CF::WN, wm = warp / CF::WN;
  const int nb0 = blockIdx.x * CF::BNB;
  const int m0 = blockIdx.y * CF::BM;
  const int k_begin = blockIdx.z * kc;
  const int k_end = min(K, k_begin + kc);
  const int n_tiles = (k_end - k_begin + CF::BK - 1) / CF::BK;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(xp);
  const size_t plane_bytes = (size_t)M * K * 2;
  // with NP = 1 the warps of the first N column sum the rows
  const bool sums = NP == 1 && wn == 0;

  auto load_stage = [&](int s, int kt) {
    uint8_t* cs = sm + s * STAGE;
    uint8_t* xs = cs + CBYTES;
    const int k0 = k_begin + kt * CF::BK;
    for_each_chunk(CF::BK, CF::BNB / wc, tid, CF::THREADS, [&](int r, int c) {
      const int k = k0 + r, jb = nb0 + c * wc;
      const bool v = k < k_end && jb < NB;
      copy_chunk(cs + code_off(r, c * wc),
                 codes + (v ? (size_t)k * NB + jb : 0), v, wc);
    });
    const int epc = wx / 2;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      for_each_chunk(CF::BM, CF::BK / epc, tid, CF::THREADS,
                     [&](int r, int c) {
        const int m = m0 + r, k = k0 + c * epc;
        const bool v = m < M && k < k_end;
        copy_chunk(xs + (p * CF::BM + r) * CF::XROW + c * wx,
                   xb + p * plane_bytes + (v ? ((size_t)m * K + k) * 2 : 0),
                   v, wx);
      });
    }
  };

  float acc[NT][MT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][mt][i] = 0.f;
  float rs[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) rs[mt] = 0.f;

#pragma unroll
  for (int s = 0; s < CF::STAGES - 1; ++s) {
    if (s < n_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<CF::STAGES - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's stage is free
    const int pre = kt + CF::STAGES - 1;
    if (pre < n_tiles) load_stage(pre % CF::STAGES, pre);
    cp_async_commit();

    const uint8_t* cs = sm + (kt % CF::STAGES) * STAGE;
    const uint8_t* xs = cs + CBYTES + (wm * 8 * MT + gid) * CF::XROW;
    // this lane's word in row 16 ks + 4 tig + i (swizzle: code_off)
    const int wcol = ((((wn * 32 + 4 * gid) >> 4) ^ (2 * tig)) << 4) +
                     4 * (gid & 3);
#pragma unroll
    for (int ks = 0; ks < CF::BK / 16; ++ks) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(
            cs + (16 * ks + 4 * tig + i) * 128 + wcol);
      uint32_t a[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) unpack_tile<CPB>(w, t, a[t]);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t b[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              xs + (p * CF::BM + mt * 8) * CF::XROW + (16 * ks + 4 * tig) * 2);
          b[mt][0] = v.x;
          b[mt][1] = v.y;
          if (p == 0 && sums) {
            const float2 f0 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&v.x));
            const float2 f1 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&v.y));
            rs[mt] += (f0.x + f0.y) + (f1.x + f1.y);
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_16816(acc[t][mt], a[t], b[mt][0], b[mt][1]);
      }
    }
  }
  cp_async_wait<0>();

  // rowsums: from the split kernel (NP = 3) or the first N column of warps
  if (NP == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float r = quad_sum(rs[mt]);
      const int row = wm * 8 * MT + mt * 8 + gid;
      if (sums && tig == 0) {
        rs_s[row] = r;
        if (part != nullptr && blockIdx.x == 0 && m0 + row < M)
          part_rs[(size_t)blockIdx.z * M + m0 + row] = r;
      }
    }
    __syncthreads();
  }

  // epilogue: the lane's outputs are rows m = 2tig, 2tig + 1 of each m tile
  // and the 4 * CPB consecutive n of its word
  const int N = NB * CPB;
  const int nbase = (nb0 + wn * 32 + 4 * gid) * CPB;
  const bool vec = N % 4 == 0 && nbase + 4 * CPB <= N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 8 * MT + mt * 8 + 2 * tig + h;
      const int m = m0 + row;
      if (m >= M) continue;
      float out[4 * CPB];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        out[2 * t] = acc[t][mt][h];
        out[2 * t + 1] = acc[t][mt][2 + h];
      }
      float* dst;
      if (part != nullptr) {
        dst = part + ((size_t)blockIdx.z * M + m) * N;
      } else {
        dst = y + (size_t)m * N;
        const float rm = NP == 1 ? rs_s[row] : row_sum(rowsum, m, n_chunks);
#pragma unroll
        for (int c = 0; c < 4 * CPB; ++c) {
          const int n = nbase + c;
          if (n < N) {
            const float sc = __ldg(scale + n);
            out[c] = out[c] * sc + rm * (sc * __ldg(z + n));
          }
        }
      }
      if (vec) {
#pragma unroll
        for (int c = 0; c < 4 * CPB; c += 4)
          *reinterpret_cast<float4*>(dst + nbase + c) =
              make_float4(out[c], out[c + 1], out[c + 2], out[c + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4 * CPB; ++c)
          if (nbase + c < N) dst[nbase + c] = out[c];
      }
    }
  }
}

// sums the K splits and applies scale and zero-point; the row sums come
// from the split kernel's chunk sums `rowsum` or, where that is null, the
// splits' part_rs
__global__ void qmm_epilogue_kernel(const float* __restrict__ part,
                                    const float* __restrict__ part_rs,
                                    const float* __restrict__ rowsum,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ z,
                                    float* __restrict__ y, int M, int N,
                                    int ksplit, int n_chunks) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (n >= N) return;
  float acc = 0.f, rs = 0.f;
  for (int s = 0; s < ksplit; ++s) {
    acc += part[((size_t)s * M + m) * N + n];
    if (rowsum == nullptr) rs += part_rs[(size_t)s * M + m];
  }
  if (rowsum != nullptr) rs = row_sum(rowsum, m, n_chunks);
  const float sc = scale[n];
  y[(size_t)m * N + n] = acc * sc + rs * (sc * z[n]);
}

bool aligned(const void* p, int w) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(w - 1)) == 0;
}

// the widest copy (bytes) that divides a row of `row_bytes` and the base
int copy_width(const void* base, long long row_bytes, int min_w) {
  for (int w = 16; w > min_w; w /= 2)
    if (row_bytes % w == 0 && aligned(base, w)) return w;
  return min_w;
}

struct Args {
  const bf16* xp;
  const float* rowsum;
  const void* codes;
  const float* scale;
  const float* z;
  float* y;
  float* part;
  float* part_rs;
  int M, K, NB, ksplit, kc, n_chunks;
};

template <int CPB, int NP, class CF>
int launch_cfg(const Args& a, cudaStream_t st) {
  auto kern = qmm_kernel<CPB, NP, CF>;
  const int smem = CF::STAGES * stage_bytes<CF, NP>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)   // room for as many blocks an SM as fit
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  const int wx = copy_width(a.xp, (long long)a.K * 2, 2);
  const int wc = copy_width(a.codes, a.NB, 1);
  const dim3 grid((a.NB + CF::BNB - 1) / CF::BNB, (a.M + CF::BM - 1) / CF::BM,
                  a.ksplit);
  kern<<<grid, CF::THREADS, smem, st>>>(
      a.xp, a.rowsum, (const uint8_t*)a.codes, a.scale, a.z, a.y,
      a.ksplit > 1 ? a.part : nullptr, a.part_rs, a.M, a.K, a.NB, a.kc, wx,
      wc, a.n_chunks);
  return (int)cudaGetLastError();
}

template <int CPB, int NP>
int launch_np(bool big, const Args& a, cudaStream_t st) {
  if (!big) return launch_cfg<CPB, NP, Cfg8>(a, st);
  if constexpr (CPB == 4) {
    return launch_cfg<CPB, NP, CfgBig4>(a, st);
  } else {
    return launch_cfg<CPB, NP, CfgBig>(a, st);
  }
}

template <int NP>
int launch_cpb(int cpb, bool big, const Args& a, cudaStream_t st) {
  switch (cpb) {
    case 1:
      return launch_np<1, NP>(big, a, st);
    case 2:
      return launch_np<2, NP>(big, a, st);
    case 4:
      return launch_np<4, NP>(big, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// A call's launch plan. `big`: the M >= 64 configuration. K is cut into
// ksplit runs of kc rows (a multiple of a stage's k rows) when the (N, M)
// tiles alone give fewer than n_sm blocks, so that there are about four
// blocks an SM (the decode blocks stream codes; the more in flight, the
// closer to the HBM rate); a run is at least two stages. The f32
// workspace holds, each region 16-byte aligned and present only where
// needed: the bf16 planes and chunk sums of an f32 X's split, then the
// split-K partial sums and partial rowsums.
struct Plan {
  bool big;
  int ksplit, kc, n_chunks;
  long long off[4];     // region offsets in floats
  long long ws_floats;  // workspace size in floats
};

Plan make_plan(int M, int K, int NB, int cpb, int x_bf16, int n_sm) {
  Plan p{};
  p.big = M >= 64;
  const int rows = !p.big ? Cfg8::BM : cpb == 4 ? CfgBig4::BM : CfgBig::BM;
  const int bk = p.big ? CfgBig::BK : Cfg8::BK;
  const long long tiles = cdiv(NB, Cfg8::BNB) * cdiv(M, rows);
  long long ks = 1;
  if (tiles < n_sm)
    ks = std::max(1LL, std::min(cdiv(4LL * n_sm, tiles), cdiv(K, 2 * bk)));
  p.kc = (int)(cdiv(cdiv(K, ks), bk) * bk);
  p.ksplit = (int)cdiv(K, p.kc);
  p.n_chunks = (int)cdiv(K, kSplitChunk);
  const long long M_ = M, K_ = K, N = (long long)NB * cpb;
  long long sizes[4] = {0, 0, 0, 0};
  if (!x_bf16) {
    sizes[0] = cdiv(3 * M_ * K_, 2);
    sizes[1] = M_ * p.n_chunks;
  }
  if (p.ksplit > 1) {
    sizes[2] = p.ksplit * M_ * N;
    sizes[3] = p.ksplit * M_;
  }
  for (int i = 0; i < 4; ++i) {
    p.off[i] = p.ws_floats;
    p.ws_floats += cdiv(sizes[i], 4) * 4;
  }
  return p;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The plan of a call on n_sm SMs (see make_plan): out = {1 for the M >= 64
// configuration else 0, ksplit, kc, workspace floats}.
int quant_matmul_plan(int M, int K, int NB, int cpb, int x_bf16, int n_sm,
                      long long* out) {
  if (M <= 0 || K <= 0 || NB <= 0 || n_sm <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, NB, cpb, x_bf16, n_sm);
  out[0] = p.big;
  out[1] = p.ksplit;
  out[2] = p.kc;
  out[3] = p.ws_floats;
  return 0;
}

// x (M,K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), codes (K,NB) uint8 with
// N = NB*cpb, scale/z (N,) f32, y (M,N) f32; ws an f32 device workspace
// of ws_floats floats, at least what quant_matmul_plan names (may be null
// where that is 0).
int quant_matmul(const void* x, const void* codes, const void* scale,
                 const void* z, void* y, void* ws, long long ws_floats,
                 int M, int K, int NB, int cpb, int x_bf16, int n_sm,
                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || K <= 0 || NB <= 0 || n_sm <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, NB, cpb, x_bf16, n_sm);
  if (ws_floats < p.ws_floats) return (int)cudaErrorInvalidValue;
  float* w = (float*)ws;
  const int ksplit = p.ksplit, n_chunks = p.n_chunks;
  Args a{(const bf16*)x, nullptr, codes, (const float*)scale,
         (const float*)z, (float*)y, w + p.off[2], w + p.off[3],
         M, K, NB, ksplit, p.kc, n_chunks};
  int rc;
  if (x_bf16) {
    rc = launch_cpb<1>(cpb, p.big, a, st);
  } else {
    bf16* planes = (bf16*)(w + p.off[0]);
    float* rowsum = w + p.off[1];
    qmm_split_x_kernel<<<dim3(n_chunks, M), 256, 0, st>>>(
        (const float*)x, planes, rowsum, M, K);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    a.xp = planes;
    a.rowsum = rowsum;
    rc = launch_cpb<3>(cpb, p.big, a, st);
  }
  if (rc != 0 || ksplit == 1) return rc;
  const int N = NB * cpb;
  const dim3 egrid((N + 255) / 256, M);
  qmm_epilogue_kernel<<<egrid, 256, 0, st>>>(
      a.part, a.part_rs, a.rowsum,
      (const float*)scale, (const float*)z, (float*)y, M, N, ksplit,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
