// adamw: one parameter leaf's whole AdamW update in one pass, for Hopper
// (sm_90a), with f32 moments or with the blockwise int8 moment codec.
//
// Replaces no Pallas kernel. The JAX package's update
// (src/repro/optim/adamw.py:154, `adamw_update`'s `upd`) runs inside the
// jitted train step, where XLA fuses each leaf's decode, update and encode
// into a few loops. Eager PyTorch ran it as ~20 passes a leaf (more with
// the codec), each reading and writing whole f32 temporaries. Plain
// version: repro_torch.kernels.adamw.adamw_leaf_plain (the same
// arithmetic in PyTorch ops, in place).
//
//   g'  = g * factor                        (the clip factor, if given)
//   m'  = b1 * m + (1 - b1) * g'
//   v'  = b2 * v + ((1 - b2) * g') * g'
//   p'  = p - lr * ((m' / c1) / (sqrt(v' / c2) + eps) + wd * p)
//
// lr, c1 = 1 - b1^t, c2 = 1 - b2^t and factor are f32 scalars on the card
// (the step computes them from its device counter, so a CUDA graph of the
// step reads them anew at every replay); b1, 1 - b1, b2, 1 - b2, eps and
// wd come rounded to f32 as PyTorch rounds a Python scalar operand.
//
// Every operation is one IEEE f32 operation in the order the plain version
// performs it: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so that no
// multiply and add contract into an FMA (the build leaves contraction
// on), __fsqrt_rn for the roots, rintf (round half to even) for
// torch.round. So m, v and the codes equal the plain version's on the
// same card bit for bit. The plain f32 path's sqrt is PyTorch's CUDA sqrtf;
// the codec's roots are f64 roots rounded to f32, which are the correctly
// rounded f32 roots (53 >= 2*24 + 2 bits), as __fsqrt_rn gives.
//
// int8 moments (the layout of the codec in repro_torch.kernels.adamw,
// which owns it: encode_m, encode_v, decode_m, decode_v): a leaf of R rows of d
// (the last dim; a 0-d leaf is one element) keeps its codes in rows padded
// to dpad = 256 * ceil(d / 256): the signed first moment as int8 codes q
// with (R, dpad / 256) f32 block scales and 2-bit error-feedback codes
// packed 4 to a byte, low pair first, (R, dpad / 4); the second moment as
// uint8 power-law codes with their block scales. Decode:
//   m = q * s + (e - 2) * (s / 3),  v = ((u / 255)^2)^2 * s_v.
// Encode from a block's new values (zeros in the padding):
//   s = absmax > 0 ? absmax / 127 : 1,  q = clamp(rint(m / s), -127, 127),
//   e = clamp(rint((m - q * s) / (s / 3)), -2, 1) + 2;
//   s_v = max > 0 ? max : 1,  u = rint(sqrt(sqrt(clamp(v / s_v, 0, 1)))
//   * 255).
//
// What bounds it on the H100: bytes. A parameter costs 17 flops (f32
// moments; ~41 with the codec) against 28 bytes (p, g, m, v read, p, m, v
// written; ~16.6 with the codec), far below the f32 ridge of ~20 flops a
// byte: 3.35 TB/s sets the time.
//
// Design: f32 moments — a grid-stride loop, 4 consecutive elements a
// thread (float4 when every pointer is 16-byte aligned and the chunk is
// whole). int8 moments — one warp a 256-element block of a row, 8
// consecutive elements a lane (float4 loads where aligned and in bounds,
// one 8-byte code load and store a lane and moment, one 16-bit EF store);
// the block's absmax is a warp-shuffle max, so no shared memory and no
// second pass. Nothing is read twice from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

struct Scalars {
  float lr, c1, c2, factor;
};

__device__ __forceinline__ Scalars load_scalars(const float* lr,
                                                const float* c1,
                                                const float* c2,
                                                const float* factor) {
  Scalars s;
  s.lr = *lr;
  s.c1 = *c1;
  s.c2 = *c2;
  s.factor = factor ? *factor : 1.0f;
  return s;
}

// The update of one element, in the plain version's order. `clip` says
// whether g is multiplied by the clip factor (a multiply by 1 would round
// nothing, but the plain version without a factor does none).
__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, const Scalars& s,
                                          const Hyper& h, bool clip) {
  if (clip) g = __fmul_rn(g, s.factor);
  const float m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mh = __fdiv_rn(m2, s.c1);
  const float vh = __fdiv_rn(v2, s.c2);
  const float den = __fadd_rn(__fsqrt_rn(vh), h.eps);
  const float delta = __fadd_rn(__fdiv_rn(mh, den), __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
  m = m2;
  v = v2;
}

// ---------------------------------------------------------------------------
// f32 moments
// ---------------------------------------------------------------------------

__global__ void adamw_f32_kernel(float* __restrict__ p,
                                 const float* __restrict__ g,
                                 float* __restrict__ m, float* __restrict__ v,
                                 long long n, int vec, const float* lr,
                                 const float* c1, const float* c2,
                                 const float* factor, Hyper h) {
  const Scalars s = load_scalars(lr, c1, c2, factor);
  const bool clip = factor != nullptr;
  const long long chunks = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < chunks; c += stride) {
    const long long i = 4 * c;
    if (vec && i + 4 <= n) {
      float4 pp = *reinterpret_cast<const float4*>(p + i);
      const float4 gg = *reinterpret_cast<const float4*>(g + i);
      float4 mm = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      adam_elem(pp.x, gg.x, mm.x, vv.x, s, h, clip);
      adam_elem(pp.y, gg.y, mm.y, vv.y, s, h, clip);
      adam_elem(pp.z, gg.z, mm.z, vv.z, s, h, clip);
      adam_elem(pp.w, gg.w, mm.w, vv.w, s, h, clip);
      *reinterpret_cast<float4*>(p + i) = pp;
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
    } else {
      for (long long j = i; j < n && j < i + 4; ++j) {
        float pj = p[j], mj = m[j], vj = v[j];
        adam_elem(pj, g[j], mj, vj, s, h, clip);
        p[j] = pj;
        m[j] = mj;
        v[j] = vj;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int8 moments: one warp a (row, 256-block)
// ---------------------------------------------------------------------------

constexpr int BLOCK = 256;
constexpr int PER_LANE = BLOCK / 32;     // 8 consecutive elements a lane
constexpr int WARPS = 8;                 // warps a thread block

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 8 floats from `src` (`n` of them in bounds, the rest 0)
__device__ __forceinline__ void load8(const float* src, int n, float* out) {
  if (n == PER_LANE && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) out[k] = k < n ? src[k] : 0.0f;
  }
}

__device__ __forceinline__ void store8(float* dst, int n, const float* in) {
  if (n == PER_LANE && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(in[0], in[1], in[2],
                                                    in[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(in[4], in[5], in[6],
                                                    in[7]);
  } else {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
      if (k < n) dst[k] = in[k];
  }
}

__global__ void __launch_bounds__(32 * WARPS)
adamw_q8_kernel(float* __restrict__ p, const float* __restrict__ g,
                int8_t* __restrict__ mq, float* __restrict__ ms,
                uint8_t* __restrict__ mef, uint8_t* __restrict__ vq,
                float* __restrict__ vs, long long rows, long long d,
                long long nb, const float* lr, const float* c1,
                const float* c2, const float* factor, Hyper h) {
  const long long blk =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);   // (row, block)
  if (blk >= rows * nb) return;
  const int lane = threadIdx.x & 31;
  const long long r = blk / nb, b = blk - r * nb;
  const long long col = b * BLOCK + lane * PER_LANE;        // in the row
  const long long dpad = nb * BLOCK;
  const long long left = d - col;
  const int n = left >= PER_LANE ? PER_LANE : (left > 0 ? (int)left : 0);
  const Scalars s = load_scalars(lr, c1, c2, factor);
  const bool clip = factor != nullptr;

  float pp[PER_LANE], gg[PER_LANE], mm[PER_LANE], vv[PER_LANE];
  load8(p + r * d + col, n, pp);
  load8(g + r * d + col, n, gg);

  // decode this lane's 8 codes of each moment
  const long long code = r * dpad + col;
  const uint2 mraw = *reinterpret_cast<const uint2*>(mq + code);
  const uint2 vraw = *reinterpret_cast<const uint2*>(vq + code);
  const uint16_t eraw = *reinterpret_cast<const uint16_t*>(mef + code / 4);
  const float sm = ms[blk], sv = vs[blk];
  const float sm3 = __fdiv_rn(sm, 3.0f);
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const uint32_t mword = k < 4 ? mraw.x : mraw.y;
    const uint32_t vword = k < 4 ? vraw.x : vraw.y;
    const int8_t qm = (int8_t)((mword >> (8 * (k & 3))) & 0xff);
    const uint8_t qv = (uint8_t)((vword >> (8 * (k & 3))) & 0xff);
    const int e = (eraw >> (2 * k)) & 3;
    mm[k] = __fadd_rn(__fmul_rn((float)qm, sm),
                      __fmul_rn((float)(e - 2), sm3));
    const float u = __fdiv_rn((float)qv, 255.0f);
    const float u2 = __fmul_rn(u, u);
    vv[k] = __fmul_rn(__fmul_rn(u2, u2), sv);
  }

  // the update; the padding's new moments are 0, as the codec pads them
  float amax_m = 0.0f, max_v = 0.0f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    if (k < n) {
      adam_elem(pp[k], gg[k], mm[k], vv[k], s, h, clip);
    } else {
      mm[k] = 0.0f;
      vv[k] = 0.0f;
    }
    amax_m = fmaxf(amax_m, fabsf(mm[k]));
    max_v = fmaxf(max_v, vv[k]);
  }
  store8(p + r * d + col, n, pp);
  amax_m = warp_max(amax_m);
  max_v = warp_max(max_v);

  // re-encode on the block's new scales
  const float scm = amax_m > 0.0f ? __fdiv_rn(amax_m, 127.0f) : 1.0f;
  const float stepm = __fdiv_rn(scm, 3.0f);
  const float scv = max_v > 0.0f ? max_v : 1.0f;
  uint32_t mw[2] = {0u, 0u}, vw[2] = {0u, 0u}, ew = 0u;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(mm[k], scm)), -127.0f),
                          127.0f);
    const float resid = __fsub_rn(mm[k], __fmul_rn(q, scm));
    const float e = fminf(fmaxf(rintf(__fdiv_rn(resid, stepm)), -2.0f),
                          1.0f) + 2.0f;
    const float frac = fminf(fmaxf(__fdiv_rn(vv[k], scv), 0.0f), 1.0f);
    const float u = rintf(__fmul_rn(__fsqrt_rn(__fsqrt_rn(frac)), 255.0f));
    mw[k >> 2] |= (uint32_t)(uint8_t)(int8_t)q << (8 * (k & 3));
    vw[k >> 2] |= (uint32_t)(uint8_t)u << (8 * (k & 3));
    ew |= (uint32_t)e << (2 * k);
  }
  *reinterpret_cast<uint2*>(mq + code) = make_uint2(mw[0], mw[1]);
  *reinterpret_cast<uint2*>(vq + code) = make_uint2(vw[0], vw[1]);
  *reinterpret_cast<uint16_t*>(mef + code / 4) = (uint16_t)ew;
  if (lane == 0) {
    ms[blk] = scm;
    vs[blk] = scv;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// f32 moments: p, g, m, v (n,) f32, updated in place (g read only). vec: 1
// when every pointer is 16-byte aligned. lr, c1, c2: f32 scalars on the
// card; factor: one too, or null for no clip factor.
int adamw_f32(void* p, const void* g, void* m, void* v, long long n,
              int vec, const void* lr, const void* c1, const void* c2,
              const void* factor, float b1, float omb1, float b2, float omb2,
              float eps, float wd, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const long long chunks = (n + 3) / 4;
  const long long want = (chunks + 255) / 256;
  const int grid = (int)(want < 132 * 32 ? want : 132 * 32);
  adamw_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (float*)m, (float*)v, n, vec,
      (const float*)lr, (const float*)c1, (const float*)c2,
      (const float*)factor, h);
  return (int)cudaGetLastError();
}

// int8 moments: p, g (rows, d) f32; mq (rows, dpad) int8, ms (rows, nb)
// f32, mef (rows, dpad / 4) uint8; vq (rows, dpad) uint8, vs (rows, nb)
// f32, with dpad = 256 * nb >= d. Code rows must be 8-byte aligned.
int adamw_q8(void* p, const void* g, void* mq, void* ms, void* mef, void* vq,
             void* vs, long long rows, long long d, long long nb,
             const void* lr, const void* c1, const void* c2,
             const void* factor, float b1, float omb1, float b2, float omb2,
             float eps, float wd, void* stream) {
  if (rows <= 0 || d <= 0 || nb * BLOCK < d) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const long long warps = rows * nb;
  const long long grid = (warps + WARPS - 1) / WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adamw_q8_kernel<<<(unsigned)grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (int8_t*)mq, (float*)ms, (uint8_t*)mef,
      (uint8_t*)vq, (float*)vs, rows, d, nb, (const float*)lr,
      (const float*)c1, (const float*)c2, (const float*)factor, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
