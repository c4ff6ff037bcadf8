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
// Every value is the one IEEE f32 operation the plain version performs,
// in its order: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so that no
// multiply and add contract into an FMA (the build leaves contraction
// on), __fsqrt_rn for the roots, round half to even for torch.round. So
// m, v and the codes equal the plain version's on the same card bit for
// bit. The plain f32 path's sqrt is PyTorch's CUDA sqrtf; the codec's
// roots are f64 roots rounded to f32, which are the correctly rounded f32
// roots (53 >= 2*24 + 2 bits), as __fsqrt_rn gives.
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
// What bounds it on the H100: bytes, with f32 moments. A parameter costs
// 17 flops against 28 bytes (p, g, m, v read, p, m, v written), far below
// the f32 ridge of ~20 flops a byte: 3.35 TB/s sets the time. With the
// codec a parameter moves ~16.6 bytes, and an operation-for-operation
// translation (7 IEEE divisions, 3 roots and 9 int <-> float conversions
// an element, each division or root ~10 issued instructions with one on
// the MUFU pipe) is bound by instruction issue instead (tools/
// adamw_ab.py, `--ref` with such a source). So the int8 path computes the
// same values with fewer instructions:
//   - Division by a divisor shared by many numerators (c1, c2 for the
//     launch; the block scales scm, stepm and scv for a warp; 3 and 127)
//     is a corrected multiply by the divisor's correctly rounded
//     reciprocal (`Recip`, `div_fast`): a faithful first quotient, its
//     remainder by an FMA (exact), one FMA correction, which Markstein's
//     theorem makes the IEEE quotient while every intermediate is a
//     normal number (`in_range`). The update's c1 and c2 quotients are
//     taken this way and their numerators checked; a block where a lane
//     meets one out of range (rare: tiny, huge or not finite) is updated
//     again from its inputs with __fdiv_rn. The encode's quotients need
//     only their codes: for a block scale in [2^-60, 2^100] a numerator
//     below the range has a quotient under 2^-40 either way, whose codes
//     are 0, so no check is made; a scale outside takes __fdiv_rn.
//     `adamw_div_probe` runs both over all 2^32 numerators against
//     __fdiv_rn (chip_smoke 19(a) gates it at 0 mismatches).
//   - The v decode's ((u / 255)^2)^2 is a 256-entry table that each
//     thread block builds once in shared memory by those three roundings.
//   - The v encode's u = rint(255 sqrt(sqrt(frac))) is monotone in frac:
//     it counts the thresholds T_1..T_255 (the least f32 frac whose code
//     is k, built on the host from encode_v itself and passed by value)
//     that frac reaches. A 2305-entry shared table, indexed by frac's
//     exponent and 6 top mantissa bits, holds the count at each bucket's
//     start; a bucket spans under one code, so one more compare with the
//     next threshold finishes it. (Two roots cost more in a training
//     step, where most of the embedding's fracs are 0: `__fsqrt_rn`'s
//     slow path; tools/adamw_ab.py `roots`, `--step`.)
//   - rint and the float <-> int conversions of the codes go through the
//     1.5 * 2^23 bias (x + 1.5 * 2^23 rounds x half to even to an integer
//     in the low mantissa bits, for |x| < 2^22), on the FMA and integer
//     pipes instead of the conversion unit; the codes' float clamps stay
//     as they were, so NaN and infinities clamp alike.
// The per-element mh / den and sqrt(vh) stay __fdiv_rn and __fsqrt_rn.
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

// ---------------------------------------------------------------------------
// division by a divisor shared by many numerators
// ---------------------------------------------------------------------------

// A positive divisor b in [2^-100, 2^100] with its correctly rounded
// reciprocal y = RN(1/b), the reciprocal's low part ylo = RN((1 - b y) y)
// (1 - b y is exact: Boldo and Daumas), and the numerator magnitudes
// [lo, hi] over which `div_fast` is the IEEE quotient:
//   lo = max(2^-100, b 2^-100): the numerator, the quotient and the
//        remainder's last bit are normal numbers;
//   hi = min(FLT_MAX, b 2^126): the quotient and a y stay finite.
// Any other divisor has lo = inf, hi = -1: no numerator is in range.
struct Recip {
  float b, y, ylo, lo, hi;
};

__device__ __forceinline__ Recip recip_of(float b) {
  Recip d;
  d.b = b;
  d.y = __frcp_rn(b);
  d.ylo = __fmul_rn(__fmaf_rn(-b, d.y, 1.0f), d.y);
  const bool ok = b >= 0x1p-100f && b <= 0x1p100f;
  d.lo = ok ? fmaxf(0x1p-100f, __fmul_rn(b, 0x1p-100f))
            : __int_as_float(0x7f800000);   // +inf
  d.hi = ok ? fminf(3.40282347e38f, __fmul_rn(b, 0x1p126f)) : -1.0f;
  return d;
}

// q0 = RN(a y + RN(a ylo)) is within an ulp of a / b (y + ylo is 1/b to
// ~2^-47), so r = a - b q0 is exact and RN(q0 + r y) is RN(a / b)
// (Markstein's theorem, y within half an ulp of 1/b), for every a with
// `in_range(a, d)`; +0 gives +0.
__device__ __forceinline__ float div_fast(float a, const Recip& d) {
  const float q0 = __fmaf_rn(a, d.y, __fmul_rn(a, d.ylo));
  const float r = __fmaf_rn(-d.b, q0, a);
  return __fmaf_rn(r, d.y, q0);
}

// (bitwise, not short-circuit: a few predicate operations, no branch)
__device__ __forceinline__ bool in_range(float a, const Recip& d) {
  const float x = fabsf(a);
  return (x <= d.hi) & ((x >= d.lo) | (__float_as_uint(a) == 0u));
}

// a / d.b, bit for bit __fdiv_rn(a, d.b), for any a
__device__ __forceinline__ float div_by(float a, const Recip& d) {
  return in_range(a, d) ? div_fast(a, d) : __fdiv_rn(a, d.b);
}

// A block scale whose encode quotients take `div_fast` unchecked: in
// range, at least 2^-60 (a numerator under lo = 2^-100 then has a
// quotient under 2^-40, below every code's first step)
__device__ __forceinline__ bool codes_exact(const Recip& d) {
  return d.b >= 0x1p-60f && d.hi > 0.0f;
}

// the two bias corrections of adam_elem: IEEE divisions (f32 moments), or
// corrected multiplies by reciprocals taken once a thread whose
// numerators are checked (int8 moments: `ok` turns false on one out of
// range)
struct ExactDiv {
  float c1, c2;
  __device__ __forceinline__ float by_c1(float a) { return __fdiv_rn(a, c1); }
  __device__ __forceinline__ float by_c2(float a) { return __fdiv_rn(a, c2); }
};

struct RecipDiv {
  Recip c1, c2;
  bool ok;
  __device__ __forceinline__ float by_c1(float a) {
    ok = ok & in_range(a, c1);
    return div_fast(a, c1);
  }
  __device__ __forceinline__ float by_c2(float a) {
    ok = ok & in_range(a, c2);
    return div_fast(a, c2);
  }
};

// The update of one element, in the plain version's order. `clip` says
// whether g is multiplied by the clip factor (a multiply by 1 would round
// nothing, but the plain version without a factor does none).
template <class Div>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, const Scalars& s,
                                          const Hyper& h, bool clip,
                                          Div& div) {
  if (clip) g = __fmul_rn(g, s.factor);
  const float m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mh = div.by_c1(m2);
  const float vh = div.by_c2(v2);
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
  ExactDiv div{s.c1, s.c2};
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
      adam_elem(pp.x, gg.x, mm.x, vv.x, s, h, clip, div);
      adam_elem(pp.y, gg.y, mm.y, vv.y, s, h, clip, div);
      adam_elem(pp.z, gg.z, mm.z, vv.z, s, h, clip, div);
      adam_elem(pp.w, gg.w, mm.w, vv.w, s, h, clip, div);
      *reinterpret_cast<float4*>(p + i) = pp;
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
    } else {
      for (long long j = i; j < n && j < i + 4; ++j) {
        float pj = p[j], mj = m[j], vj = v[j];
        adam_elem(pj, g[j], mj, vj, s, h, clip, div);
        p[j] = pj;
        m[j] = mj;
        v[j] = vj;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int8 moments: a warp a (row, 256-block) at a time
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

__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// x + 1.5 * 2^23 rounds x (|x| < 2^22) half to even to an integer k,
// held as the float kRound + k whose bits are kBias + k; a code's clamps
// are taken on the held value, its bytes read from its bits
constexpr float kRound = 12582912.0f;   // 1.5 * 2^23
constexpr uint32_t kBias = 0x4B400000u; // its bits, 0 mod 256
constexpr float kHeld0 = kRound;        // where k = 0 is held

// clamp(rint(x), lo, hi), held
__device__ __forceinline__ float held_code(float x, float lo, float hi) {
  return clamp_to(__fadd_rn(x, kRound), kHeld0 + lo, kHeld0 + hi);
}

// a held k as a float, and as bits whose low byte is k's
__device__ __forceinline__ float held_float(float t) {
  return __fsub_rn(t, kHeld0);
}
__device__ __forceinline__ uint32_t held_bits(float t) {
  return __float_as_uint(t);
}

// a byte b less `off` as a float (exact)
__device__ __forceinline__ float byte_float(uint32_t b, float off) {
  return __fsub_rn(__uint_as_float(kBias | b), kRound + off);
}

// The v code's thresholds: t[k - 1] = T_k, the least f32 frac whose code
// rint(255 sqrt(sqrt(frac))) is k (k = 1..255)
struct VThresholds {
  float t[255];
};

// The v encode's buckets: frac's exponent (from 2^-36: T_1 ~ 1.48e-11 is
// above it) and its 6 top mantissa bits, 37 * 64 buckets up to frac = 1
constexpr int kBucketShift = 17;
constexpr uint32_t kBucketFirst = 91u << 6;    // 2^-36 >> kBucketShift
constexpr int kBuckets = 36 * 64 + 1;

// u for frac in [0, 1] (NaN clamped to 0 before): the count at frac's
// bucket start, plus one if frac reaches the next threshold
__device__ __forceinline__ uint32_t v_code(float frac, const uint8_t* base,
                                           const float* thr) {
  const int i = min(max((int)(__float_as_uint(frac) >> kBucketShift)
                            - (int)kBucketFirst, 0), kBuckets - 1);
  const uint32_t u = base[i];
  return u + (frac >= thr[u + 1] ? 1u : 0u);
}

// A lane's 8 moments from their codes: m = q * sm + (e - 2) * sm3 (q from
// its byte offset by 128), v = vdec[u] * sv
__device__ __forceinline__ void decode8(uint2 mraw, uint2 vraw, uint32_t eraw,
                                        float sm, float sm3, float sv,
                                        const float* vdec, float* mm,
                                        float* vv) {
  const uint32_t mx[2] = {mraw.x ^ 0x80808080u, mraw.y ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int sh = 8 * (k & 3);
    const float qm = byte_float((mx[k >> 2] >> sh) & 0xffu, 128.0f);
    const float e2 = byte_float((eraw >> (2 * k)) & 3u, 2.0f);
    mm[k] = __fadd_rn(__fmul_rn(qm, sm), __fmul_rn(e2, sm3));
    const uint32_t qv = ((k < 4 ? vraw.x : vraw.y) >> sh) & 0xffu;
    vv[k] = __fmul_rn(vdec[qv], sv);
  }
}

// the update of a lane's 8 elements, the padding's too (its p, g and
// codes are zeros: it computes zeros, and its p is not stored); the
// padding's new moments are 0, as the codec pads them. No branch a lane.
template <class Div>
__device__ __forceinline__ void update8(float* pp, const float* gg,
                                        float* mm, float* vv, int n,
                                        const Scalars& s, const Hyper& h,
                                        bool clip, Div& div) {
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    adam_elem(pp[k], gg[k], mm[k], vv[k], s, h, clip, div);
    mm[k] = k < n ? mm[k] : 0.0f;
    vv[k] = k < n ? vv[k] : 0.0f;
  }
}

// the division of one encode site: `div_fast` (Fast) or __fdiv_rn
template <bool Fast>
__device__ __forceinline__ float enc_div(float a, const Recip& d) {
  return Fast ? div_fast(a, d) : __fdiv_rn(a, d.b);
}

// A lane's 8 codes of each moment on the block's new scales
template <bool Fast>
__device__ __forceinline__ void encode8(const float* mm, const float* vv,
                                        float scm, const Recip& rm,
                                        const Recip& rstep, const Recip& rv,
                                        const uint8_t* vbase,
                                        const float* vthr, uint2& mw2,
                                        uint2& vw2, uint32_t& ew) {
  uint32_t mw[2] = {0u, 0u}, vw[2] = {0u, 0u};
  ew = 0u;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const float tq = held_code(enc_div<Fast>(mm[k], rm), -127.0f, 127.0f);
    const float resid = __fsub_rn(mm[k], __fmul_rn(held_float(tq), scm));
    const float te = held_code(enc_div<Fast>(resid, rstep), -2.0f, 1.0f);
    const float frac = clamp_to(enc_div<Fast>(vv[k], rv), 0.0f, 1.0f);
    const int sh = 8 * (k & 3);
    mw[k >> 2] |= (held_bits(tq) & 0xffu) << sh;
    vw[k >> 2] |= v_code(frac, vbase, vthr) << sh;
    ew |= ((held_bits(te) + 2u) & 3u) << (2 * k);
  }
  mw2 = make_uint2(mw[0], mw[1]);
  vw2 = make_uint2(vw[0], vw[1]);
}

// kMinBlocks thread blocks an SM: the caller's grid, as many an SM, is
// resident at once, and each warp walks its (row, block) pairs
// (kernels/adamw.py Q8_BLOCKS_PER_SM)
constexpr int kMinBlocks = 3;

__global__ void __launch_bounds__(32 * WARPS, kMinBlocks)
adamw_q8_kernel(float* __restrict__ p, const float* __restrict__ g,
                int8_t* __restrict__ mq, float* __restrict__ ms,
                uint8_t* __restrict__ mef, uint8_t* __restrict__ vq,
                float* __restrict__ vs, long long rows, long long d,
                long long nb, const float* lr, const float* c1,
                const float* c2, const float* factor, Hyper h,
                VThresholds thresholds) {
  // shared tables, built once a thread block (256 threads): the v
  // decode's ((u / 255)^2)^2 by decode_v's own three roundings; the
  // thresholds, vthr[k] = T_k (vthr[0] = 0, vthr[256] = inf); each
  // bucket's count of thresholds at its start
  __shared__ float vdec[256];
  __shared__ float vthr[257];
  __shared__ uint8_t vbase[kBuckets];
  {
    const int t = threadIdx.x;
    const float u = __fdiv_rn((float)t, 255.0f);
    const float u2 = __fmul_rn(u, u);
    vdec[t] = __fmul_rn(u2, u2);
    vthr[t + 1] = t < 255 ? thresholds.t[t] : __int_as_float(0x7f800000);
    if (t == 0) vthr[0] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBuckets; i += blockDim.x) {
    const float start = __uint_as_float((kBucketFirst + i) << kBucketShift);
    int lo = 0;                  // the last k with vthr[k] <= start
#pragma unroll
    for (int step = 128; step > 0; step >>= 1)
      if (lo + step <= 255 && vthr[lo + step] <= start) lo += step;
    vbase[i] = (uint8_t)lo;
  }
  __syncthreads();

  const Scalars s = load_scalars(lr, c1, c2, factor);
  const Recip rc1 = recip_of(s.c1), rc2 = recip_of(s.c2);
  const Recip by3 = recip_of(3.0f), by127 = recip_of(127.0f);
  const bool clip = factor != nullptr;
  const int lane = threadIdx.x & 31;
  const long long dpad = nb * BLOCK;
  const long long total = rows * nb;
  for (long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       blk < total; blk += (long long)gridDim.x * WARPS) {   // (row, block)
    // (a 32-bit division where the pairs fit: the usual case)
    const long long r = total <= 0xffffffffLL
                            ? (long long)((unsigned)blk / (unsigned)nb)
                            : blk / nb;
    const long long b = blk - r * nb;
    const long long col = b * BLOCK + lane * PER_LANE;      // in the row
    const long long left = d - col;
    const int n = left >= PER_LANE ? PER_LANE : (left > 0 ? (int)left : 0);
    float* const prow = p + r * d + col;

    float pp[PER_LANE], gg[PER_LANE], mm[PER_LANE], vv[PER_LANE];
    load8(prow, n, pp);
    load8(g + r * d + col, n, gg);
    const long long code = r * dpad + col;
    const uint2 mraw = *reinterpret_cast<const uint2*>(mq + code);
    const uint2 vraw = *reinterpret_cast<const uint2*>(vq + code);
    const uint32_t eraw = *reinterpret_cast<const uint16_t*>(mef + code / 4);
    const float sm = ms[blk], sv = vs[blk];
    const float sm3 = div_by(sm, by3);
    decode8(mraw, vraw, eraw, sm, sm3, sv, vdec, mm, vv);
    RecipDiv fast{rc1, rc2, true};
    update8(pp, gg, mm, vv, n, s, h, clip, fast);
    if (__any_sync(0xffffffffu, !fast.ok)) {
      // a c1 / c2 numerator out of the corrected multiply's range in this
      // block: update it again from its inputs with IEEE divisions
      ExactDiv exact{s.c1, s.c2};
      load8(prow, n, pp);
      decode8(mraw, vraw, eraw, sm, sm3, sv, vdec, mm, vv);
      update8(pp, gg, mm, vv, n, s, h, clip, exact);
    }
    float amax_m = 0.0f, max_v = 0.0f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      amax_m = fmaxf(amax_m, fabsf(mm[k]));
      max_v = fmaxf(max_v, vv[k]);
    }
    store8(prow, n, pp);
    amax_m = warp_max(amax_m);
    max_v = warp_max(max_v);

    // re-encode on the block's new scales
    const float scm = amax_m > 0.0f ? div_by(amax_m, by127) : 1.0f;
    const float stepm = div_by(scm, by3);
    const float scv = max_v > 0.0f ? max_v : 1.0f;
    const Recip rm = recip_of(scm), rstep = recip_of(stepm),
                rv = recip_of(scv);
    uint2 mw, vw;
    uint32_t ew;
    if (codes_exact(rm) && codes_exact(rstep) && codes_exact(rv))
      encode8<true>(mm, vv, scm, rm, rstep, rv, vbase, vthr, mw, vw, ew);
    else
      encode8<false>(mm, vv, scm, rm, rstep, rv, vbase, vthr, mw, vw, ew);
    *reinterpret_cast<uint2*>(mq + code) = mw;
    *reinterpret_cast<uint2*>(vq + code) = vw;
    *reinterpret_cast<uint16_t*>(mef + code / 4) = (uint16_t)ew;
    if (lane == 0) {
      ms[blk] = scm;
      vs[blk] = scv;
    }
  }
}

// The division probe, for each divisor b = divisors[blockIdx.y] over all
// 2^32 numerators a (the grid's x dimension walks their bits): mode 0
// counts where div_by(a, recip_of(b)) differs from __fdiv_rn(a, b) in any
// bit (the update's c1 / c2 quotients); mode 1, for a divisor that
// `codes_exact` admits and a numerator within 256 b
// (an encode numerator is within 128 times its scale: |m| <= absmax,
// |resid| < 2 stepm, v <= scv) or NaN, where div_fast does, unless both
// are below 2^-40 in magnitude (the encode's quotients, whose codes are
// then 0). Counts add to bad[i]; first[i] takes the least such
// numerator's bits.
__global__ void div_probe_kernel(const float* __restrict__ divisors,
                                 int mode, unsigned long long* bad,
                                 unsigned* first) {
  const float b = divisors[blockIdx.y];
  const Recip d = recip_of(b);
  if (mode == 1 && !codes_exact(d)) return;
  const float most = __fmul_rn(b, 256.0f);
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  unsigned n = 0;
  for (unsigned long long i =
           (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ULL << 32); i += step) {
    const unsigned bits = (unsigned)i;
    const float a = __uint_as_float(bits);
    if (mode == 1 && fabsf(a) > most) continue;
    const float want = __fdiv_rn(a, b);
    const float got = mode == 0 ? div_by(a, d) : div_fast(a, d);
    bool differ = __float_as_uint(got) != __float_as_uint(want);
    if (mode == 1 && fabsf(got) < 0x1p-40f && fabsf(want) < 0x1p-40f)
      differ = false;
    if (differ) {
      ++n;
      atomicMin(first + blockIdx.y, bits);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0 && n)
    atomicAdd(bad + blockIdx.y, (unsigned long long)n);
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
// thresholds: the 255 v-code thresholds (host memory, passed by value).
// grid: thread blocks to launch, at most kMinBlocks an SM (more wait).
int adamw_q8(void* p, const void* g, void* mq, void* ms, void* mef, void* vq,
             void* vs, long long rows, long long d, long long nb,
             const void* lr, const void* c1, const void* c2,
             const void* factor, float b1, float omb1, float b2, float omb2,
             float eps, float wd, const float* thresholds, long long grid,
             void* stream) {
  if (rows <= 0 || d <= 0 || nb * BLOCK < d || thresholds == nullptr ||
      grid <= 0 || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  VThresholds t;
  for (int k = 0; k < 255; ++k) t.t[k] = thresholds[k];
  adamw_q8_kernel<<<(unsigned)grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (int8_t*)mq, (float*)ms, (uint8_t*)mef,
      (uint8_t*)vq, (float*)vs, rows, d, nb, (const float*)lr,
      (const float*)c1, (const float*)c2, (const float*)factor, h, t);
  return (int)cudaGetLastError();
}

// The division probe (see div_probe_kernel): n f32 divisors on the card,
// every numerator, mode 0 or 1; bad (n,) u64 and first (n,) u32 on the
// card, added to / min-ed into (the caller zeroes bad and fills first with
// 0xffffffff).
int adamw_div_probe(const void* divisors, int n, int mode, void* bad,
                    void* first, void* stream) {
  if (n <= 0 || n > 65535 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  div_probe_kernel<<<dim3(2048, (unsigned)n), 256, 0,
                     (cudaStream_t)stream>>>(
      (const float*)divisors, mode, (unsigned long long*)bad,
      (unsigned*)first);
  return (int)cudaGetLastError();
}

}  // extern "C"
