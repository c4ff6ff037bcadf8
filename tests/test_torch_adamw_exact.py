"""The int8 AdamW path's exact rewrites (csrc/adamw.cu), modelled on the
CPU: the v-decode table, the corrected multiply that replaces a division
by a shared divisor, the v code counted from host-built thresholds, and
the 1.5 * 2^23 bias that replaces rint and the float <-> int conversions
of the codes. Each model is held, bit for bit, to what the plain version
computes (decode_v, numpy's IEEE f32 division, encode_v, torch.round and
the codec's casts). The card's own check of the division is
`adamw.div_probe` (tests/test_torch_cuda.py, chip_smoke 19(a))."""
import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw

torch.set_num_threads(2)
f32 = np.float32

K_ROUND = f32(12582912.0)          # 1.5 * 2^23, csrc/adamw.cu kRound
K_BIAS = 0x4B400000                 # its bits, kBias


# ---------------------------------------------------------------------------
# the v-decode table
# ---------------------------------------------------------------------------

def _vdec_table():
    """The kernel's table, by its three roundings in f32: ((u / 255)^2)^2."""
    u = torch.arange(256, dtype=torch.float32) / torch.tensor(255.0)
    u2 = u * u
    return u2 * u2


def test_vdec_table_is_decode_v_at_unit_scale():
    codes = torch.arange(256, dtype=torch.uint8)
    want = adamw.decode_v({"q": codes, "scale": torch.ones(1)}, (256,))
    assert torch.equal(_vdec_table(), want)


def test_decode_v_is_the_table_times_the_block_scale():
    """decode_v rounds once after the table: RN(T[u] * s), any scale."""
    gen = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 256, (64, 512), generator=gen,
                          dtype=torch.uint8)
    codes[0, :256] = torch.arange(256, dtype=torch.uint8)
    scale = torch.exp2(torch.rand(64, 2, generator=gen) * 200 - 100)
    got = _vdec_table()[codes.long()] * scale.repeat_interleave(256, 1)
    want = adamw.decode_v({"q": codes, "scale": scale}, (64, 512))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the corrected multiply (csrc/adamw.cu recip_of / div_by), in exact
# rational arithmetic rounded to f32
# ---------------------------------------------------------------------------

def _rn(x: Fraction) -> float:
    """x rounded to the nearest f32, ties to even (subnormals, overflow)."""
    if x == 0:
        return 0.0
    sign, x = (-1.0 if x < 0 else 1.0), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    k = x / ulp
    n, rem = divmod(k.numerator, k.denominator)
    half = Fraction(rem, k.denominator) - Fraction(1, 2)
    if half > 0 or (half == 0 and n % 2):
        n += 1
    v = n * ulp
    return sign * (math.inf if v >= Fraction(2) ** 128 else float(v))


def _q(x: float) -> Fraction:
    return Fraction(x)


def _fma(a, b, c) -> float:
    return _rn(_q(a) * _q(b) + _q(c))


def _mul(a, b) -> float:
    return _rn(_q(a) * _q(b))


def _recip_of(b: float):
    """csrc/adamw.cu recip_of: (b, y, ylo, lo, hi); a divisor outside
    [2^-100, 2^100] (or not positive) has lo = inf, hi = -1."""
    ok = 2.0 ** -100 <= b <= 2.0 ** 100
    if not ok:
        return b, math.nan, math.nan, math.inf, -1.0
    y = _rn(1 / _q(b))
    ylo = _mul(_fma(-b, y, 1.0), y)
    lo = max(2.0 ** -100, _mul(b, 2.0 ** -100))
    hi = min(float(np.finfo(f32).max), _mul(b, 2.0 ** 126))
    return b, y, ylo, lo, hi


def _div_fast(a: float, d) -> float:
    """The corrected multiply, every operation rounded once as on the
    card (an FMA's product exact); a NaN numerator gives NaN."""
    b, y, ylo, _, _ = d
    if math.isnan(a):
        return math.nan
    q0 = _fma(a, y, _mul(a, ylo))
    r = _fma(-b, q0, a)
    return _fma(r, y, q0)


def _in_range(a: float, d) -> bool:
    _, _, _, lo, hi = d
    return abs(a) <= hi and (abs(a) >= lo or _bits(a) == 0)


def _div_by(a: float, d):
    """The update's division: the corrected multiply in range, the IEEE
    quotient out of it."""
    if _in_range(a, d):
        return _div_fast(a, d)
    return float(f32(a) / f32(d[0]))


def _bits(x) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _from_bits(u) -> float:
    return float(np.array([u], dtype=np.uint32).view(f32)[0])


def _check_pairs(pairs, encode=False):
    """Each (a, b) through the update's division (or, with `encode`, the
    encode's unchecked one where the block scale admits it, over the
    numerators the encode meets: within 256 b) against numpy's IEEE f32
    quotient; the encode's may differ only where both are below 2^-40."""
    recips = {}
    bad = []
    with np.errstate(all="ignore"):
        for a, b in pairs:
            d = recips.setdefault(b, _recip_of(b))
            want = float(f32(a) / f32(b))
            if encode:
                if not (2.0 ** -60 <= b <= 2.0 ** 100) or abs(a) > 256 * b:
                    continue
                got = _div_fast(a, d)
                if abs(got) < 2.0 ** -40 and abs(want) < 2.0 ** -40:
                    continue
            else:
                got = _div_by(a, d)
            same = (_bits(got) == _bits(want)
                    or (math.isnan(got) and math.isnan(want)))
            if not same:
                bad.append((a, b, got, want))
    assert not bad, bad[:5]


def _divisors(rng):
    """Divisors as the probe picks them: the constants, all-ones mantissas
    and powers of two across the exponents, the range's edges, random."""
    out = [3.0, 127.0, 255.0, 0.05000001, 0.1, 1.0]
    out += [_from_bits((e << 23) | 0x7FFFFF) for e in range(1, 255, 23)]
    out += [_from_bits(e << 23) for e in range(1, 255, 23)]
    out += [_from_bits(u) for u in (0x0D7FFFFF, 0x0D800000, 0x71800000,
                                    0x71800001, 0x00800000, 0x7F7FFFFF)]
    out += [_from_bits(int(u)) for u in rng.integers(
        0x00800000, 0x7F800000, 12, dtype=np.int64)]
    return [float(f32(b)) for b in out]


@pytest.mark.parametrize("site", ["update", "encode"])
def test_corrected_division_model_equals_ieee_division_sampled(site):
    """Random numerators over every exponent (subnormals, zeros, the
    infinities and NaN among them), within 256 divisors' worth for the
    encode, at the probe's kinds of divisor."""
    rng = np.random.default_rng(1)
    pairs = []
    for b in _divisors(rng):
        nums = [_from_bits(int(u)) for u in rng.integers(
            0, 1 << 32, 40, dtype=np.int64)]
        with np.errstate(over="ignore"):
            nums += [float(f32(b) * f32(x))
                     for x in rng.uniform(-256, 256, 20)]
        nums += [0.0, -0.0, math.inf, -math.inf, math.nan, 2.0 ** -149]
        # numerators at the edges of the range [lo, hi] for this divisor
        _, _, _, lo, hi = _recip_of(b)
        for edge in (lo, hi):
            if 0 < edge < math.inf:
                u = _bits(edge)
                nums += [_from_bits(u - 1), edge, _from_bits(u + 1)]
        pairs += [(a, b) for a in nums]
    _check_pairs(pairs, encode=site == "encode")


def test_corrected_division_model_equals_ieee_division_adversarial():
    """Pairs where the plain reciprocal product RN(a * RN(1/b)) misses
    a / b by more than an ulp (the first quotient a one-step correction
    would start from), and quotients next to a rounding midpoint."""
    rng = np.random.default_rng(2)
    n = 400_000
    a = rng.integers(0x3F800000, 0x40000000, n, dtype=np.int64).astype(
        np.uint32).view(f32)
    b = rng.integers(0x3F800000, 0x40000000, n, dtype=np.int64).astype(
        np.uint32).view(f32)
    q0 = (a.astype(np.float64) * (f32(1) / b).astype(np.float64)).astype(f32)
    exact = a.astype(np.float64) / b.astype(np.float64)
    ulp = np.spacing(np.abs(q0)).astype(np.float64)
    off = np.abs(q0.astype(np.float64) - exact) / ulp
    q = (a / b).astype(np.float64)
    to_mid = np.abs(np.abs(exact - q) / np.spacing(q.astype(f32)) - 0.5)
    pick = np.concatenate([np.argsort(-off)[:150], np.argsort(to_mid)[:150]])
    assert off.max() > 1.0            # the plain product is not faithful
    scale = 2.0 ** rng.integers(-60, 60, pick.size)
    pairs = [(float(a[i]) * s, float(b[i])) for i, s in zip(pick, scale)]
    pairs += [(float(a[i]), float(b[i]) * s) for i, s in zip(pick, scale)]
    _check_pairs(pairs)
    _check_pairs(pairs, encode=True)


# ---------------------------------------------------------------------------
# the v code by its thresholds (csrc/adamw.cu v_code)
# ---------------------------------------------------------------------------

def _v_code_model(frac: np.ndarray) -> np.ndarray:
    """The kernel's v code: the count of thresholds at frac's bucket start
    (frac's exponent from 2^-36 and its 6 top mantissa bits), plus one
    where frac reaches the next threshold."""
    thr = np.concatenate([[0.0], adamw.v_code_thresholds(), [np.inf]]
                         ).astype(f32)
    starts = ((np.arange(36 * 64 + 1) + (91 << 6)) << 17).astype(
        np.uint32).view(f32)
    base = np.searchsorted(thr[:256], starts, side="right") - 1
    i = np.clip((frac.view(np.uint32) >> 17).astype(np.int64) - (91 << 6),
                0, 36 * 64)
    u = base[i]
    return u + (frac >= thr[u + 1])


def test_v_code_thresholds_are_encode_v_boundaries():
    """T_k has code k and the float below it k - 1 (so the codes step by
    one), and every bucket of the kernel's table holds at most one."""
    thr = np.array(adamw.v_code_thresholds(), dtype=f32)
    assert thr.shape == (255,) and bool(np.all(np.diff(thr) > 0))
    below = (thr.view(np.uint32) - 1).view(f32)
    codes = adamw._v_codes(torch.from_numpy(np.concatenate([thr, below])))
    assert codes[:255].tolist() == list(range(1, 256))
    assert codes[255:].tolist() == list(range(0, 255))
    bucket = (thr.view(np.uint32) >> 17).astype(np.int64) - (91 << 6)
    assert bucket.min() >= 0 and np.bincount(bucket).max() <= 1


def test_v_code_model_equals_encode_v():
    """The kernel's lookup against encode_v: every threshold and its two
    neighbours, every bucket start and the float below it, 0, 1, and
    random fracs over every exponent."""
    rng = np.random.default_rng(5)
    thr = np.array(adamw.v_code_thresholds(), dtype=f32).view(np.uint32)
    starts = ((np.arange(36 * 64 + 1) + (91 << 6)) << 17).astype(np.uint32)
    bits = np.concatenate([thr - 1, thr, thr + 1, starts, starts - 1,
                           rng.integers(0, 0x3F800001, 20_000),
                           [0, 0x3F800000]]).astype(np.uint32)
    frac = bits.view(f32)
    want = adamw._v_codes(torch.from_numpy(frac)).numpy()
    assert np.array_equal(_v_code_model(frac), want)


# ---------------------------------------------------------------------------
# the 1.5 * 2^23 bias: rint, the clamps and the code bytes
# ---------------------------------------------------------------------------

def test_bias_rounds_half_to_even_as_torch_round():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-300, 300, 200_000).astype(f32),
        (np.arange(-600, 601) / f32(2)).astype(f32),          # the ties
        np.array([0.0, -0.0, 0.49999997, -0.49999997, 2 ** 22 - 0.5,
                  -(2 ** 22) + 0.5], dtype=f32)])
    t = (x + K_ROUND).astype(f32)
    k = t.view(np.uint32).astype(np.int64) - K_BIAS
    assert np.array_equal(k, torch.round(torch.from_numpy(x)).long().numpy())


@pytest.mark.parametrize("lo,hi", [(-127, 127), (-2, 1)])
def test_bias_clamps_and_code_bytes_match_the_codec(lo, hi):
    """clamp(rint(x), lo, hi) taken on x + kRound (NaN and the infinities
    clamp as fminf / fmaxf clamp them), then the code from the bits: the
    int8 byte (m) or e + 2 (the EF pair)."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-300, 300, 20_000).astype(f32),
                        np.array([np.inf, -np.inf], dtype=f32)])
    with np.errstate(invalid="ignore"):
        t = np.fmin(np.fmax((x + K_ROUND).astype(f32), K_ROUND + lo),
                    K_ROUND + hi)
        nan = np.fmin(np.fmax(f32(np.nan) + K_ROUND, K_ROUND + lo),
                      K_ROUND + hi)
    assert nan == K_ROUND + lo        # as fminf(fmaxf(NaN, lo), hi) = lo
    bits = t.view(np.uint32)
    want = torch.clamp(torch.round(torch.from_numpy(x)), lo, hi)
    if hi == 127:
        got = (bits & 0xFF).astype(np.uint8).view(np.int8)
        assert np.array_equal(got, want.to(torch.int8).numpy())
    else:
        got = (bits + 2) & 3
        assert np.array_equal(got, (want + 2).long().numpy())


def test_bias_decodes_every_code_byte():
    """m's int8 byte and the EF pair back to floats through the bias: the
    byte xor 0x80 under kBias, less kRound + 128; the pair less
    kRound + 2."""
    raw = np.arange(256, dtype=np.uint32)
    q = ((K_BIAS | (raw ^ 0x80)).astype(np.uint32).view(f32)
         - f32(K_ROUND + 128)).astype(f32)
    assert np.array_equal(q, raw.astype(np.uint8).view(np.int8).astype(f32))
    e = np.arange(4, dtype=np.uint32)
    e2 = ((K_BIAS | e).astype(np.uint32).view(f32)
          - f32(K_ROUND + 2)).astype(f32)
    assert np.array_equal(e2, (e.astype(f32) - 2))


# ---------------------------------------------------------------------------
# the wrappers refuse CPU tensors
# ---------------------------------------------------------------------------

def test_cuda_entry_points_refuse_cpu_tensors():
    from repro_torch.optim import AdamWConfig
    one = torch.ones(())
    p = torch.ones(4, 300)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        adamw.adamw_leaf_cuda(p, p, adamw.encode_m(p), adamw.encode_v(p),
                              lr=one, c1=one, c2=one,
                              cfg=AdamWConfig(moment_dtype="int8"))
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        adamw.div_probe(torch.tensor([3.0]))
