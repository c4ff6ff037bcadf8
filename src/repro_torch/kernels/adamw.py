"""`adamw`: one parameter leaf's AdamW update (f32 moments, or the
blockwise int8 moment codec) in one pass — Hopper kernel (csrc/adamw.cu)
and its plain version, with the codec both share.

Replaces no Pallas kernel: the JAX package's update
(`src/repro/optim/adamw.py:154`, `adamw_update`'s `upd`) is fused by XLA
inside the jitted train step. Eager PyTorch runs it as ~20 passes a leaf,
more with the codec; the kernel reads p, g and the moments once and writes
p and the moments once, in place.

The codec (the optimizer's moment state; this module owns its layout,
and the optimizer, csrc/adamw.cu and the tests go through `encode_m`,
`encode_v`, `decode_m` and `decode_v`): the signed first moment as int8
codes on per-256-block absmax scales with 2-bit error-feedback codes
(`pack2`), the second moment as power-law uint8 codes; rows padded along
the last dim to a multiple of BLOCK, a 0-d leaf one element. Rounding is
round half to even (`torch.round`), divisions are true divisions on every
device (`_div`) and roots correctly rounded (`_sqrt`), so the CPU's codes
are the card's.

Tolerance: the kernel rounds as the plain version does, operation for
operation (csrc/adamw.cu), so on one card m, v and the codes, scales and
EF bytes are bit-identical to the plain version's; p is held within 1e-6
of |p| + 10 lr (the f32 path's square root is PyTorch's there). The int8
path divides by a divisor shared across a launch or a block as a
corrected multiply by its reciprocal, exact where every intermediate is
normal and __fdiv_rn elsewhere; `div_probe` counts where it would differ
from the IEEE quotient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

Tensor = torch.Tensor
NAME = "adamw"
launches = 0     # kernel launches since the last reset (chip_smoke reads it)

BLOCK = 256
# the plain in-place update's slab: a larger leaf is updated CHUNK entries
# at a time (whole rows), which bounds its temporaries
CHUNK = 1 << 24

_COMMON = [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_void_p]
_F32_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                 + _COMMON)
_Q8_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3
                + _COMMON[:-1] + [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p])
_PROBE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# the int8 kernel's thread blocks (8 warps, one (row, block) pair a warp
# at a time) an SM: its __launch_bounds__ minimum, so a grid of this many
# an SM is resident at once
Q8_BLOCKS_PER_SM = 3
Q8_WARPS = 8


# ---------------------------------------------------------------------------
# blockwise int8 moment codec
# ---------------------------------------------------------------------------

def _div(x: Tensor, c: float) -> Tensor:
    """x / c as a true f32 division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which rounds
    otherwise; a one-element divisor on x's device is divided by, as on the
    CPU and in the JAX package, so the codes are the same on the card."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _sqrt(x: Tensor) -> Tensor:
    """The correctly rounded f32 square root on every device: PyTorch's
    CUDA f32 sqrt may miss it by an ulp, the f64 one does not, and an f64
    root rounded to f32 is the f32 root (53 ≥ 2·24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def _blocked(x: Tensor):
    """(x padded along its last dim to a multiple of BLOCK, its blocks
    (*lead, nblocks, BLOCK)); a 0-d x is one element."""
    x = x.reshape(1) if x.dim() == 0 else x
    d = x.shape[-1]
    xp = F.pad(x, (0, (-d) % BLOCK))
    return xp, xp.reshape(*xp.shape[:-1], -1, BLOCK)


def pack2(c: Tensor) -> Tensor:
    """{0..3} codes (last dim % 4 == 0) packed 4-per-uint8, low pair first."""
    c4 = c.to(torch.uint8).reshape(*c.shape[:-1], -1, 4)
    return (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
            | (c4[..., 3] << 6))


def unpack2(b: Tensor) -> Tensor:
    parts = torch.stack([(b >> (2 * i)) & 3 for i in range(4)], dim=-1)
    return parts.reshape(*b.shape[:-1], b.shape[-1] * 4)


def encode_m(x: Tensor) -> Dict[str, Tensor]:
    """Blockwise (last-dim, 256) linear int8 for the signed first moment,
    with the rounding residual as 2-bit error-feedback codes ("ef", packed
    4/byte on the same block scale). q/scale/ef keep the param's rank."""
    xp, blocks = _blocked(x.float())
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, _div(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    resid = blocks - q * scale[..., None]          # |resid| <= scale/2
    step = _div(scale[..., None], 3.0)
    eq = torch.clamp(torch.round(resid / step), -2, 1) + 2
    return {"q": q.reshape(xp.shape).to(torch.int8),
            "scale": scale.to(torch.float32),
            "ef": pack2(eq.reshape(xp.shape))}


def decode_m(enc: Dict[str, Tensor], shape) -> Tensor:
    q = enc["q"]
    blocks = q.reshape(*q.shape[:-1], -1, BLOCK).float()
    x = blocks * enc["scale"][..., None]
    if "ef" in enc:                                # error-feedback add-back
        eq = unpack2(enc["ef"]).float() - 2.0
        x = x + (eq.reshape(*q.shape[:-1], -1, BLOCK)
                 * _div(enc["scale"][..., None], 3.0))
    x = x.reshape(q.shape)
    d = shape[-1] if len(shape) else 1
    return x[..., :d].reshape(shape)


def encode_v(x: Tensor) -> Dict[str, Tensor]:
    """Power-law uint8 codec for the non-negative second moment: linear
    int8 rounds small v to exactly 0 and 1/√v̂ explodes; storing
    (v/absmax)^(1/4) keeps ~4 decades of relative resolution."""
    xp, blocks = _blocked(x.float())
    absmax = blocks.amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    frac = torch.clamp(blocks / scale[..., None], 0.0, 1.0)
    q = torch.round(_sqrt(_sqrt(frac)) * 255.0)
    return {"q": q.reshape(xp.shape).to(torch.uint8),
            "scale": scale.to(torch.float32)}


def decode_v(enc: Dict[str, Tensor], shape) -> Tensor:
    q = enc["q"]
    blocks = _div(q.reshape(*q.shape[:-1], -1, BLOCK).float(), 255.0)
    frac = torch.square(torch.square(blocks))
    x = (frac * enc["scale"][..., None]).reshape(q.shape)
    d = shape[-1] if len(shape) else 1
    return x[..., :d].reshape(shape)


def _v_codes(frac: Tensor) -> Tensor:
    """encode_v's code of each f32 frac in [0, 1] (each in a block whose
    max is 1, so the quotient is frac itself)."""
    x = torch.zeros(frac.numel(), BLOCK)
    x[:, 0] = 1.0
    x[:, 1] = frac
    return encode_v(x)["q"][:, 1].long()


@functools.lru_cache(maxsize=None)
def v_code_thresholds() -> Tuple[float, ...]:
    """T_1..T_255: the least f32 frac in [0, 1] whose encode_v code is k
    (the code is monotone in frac), found by bisection over f32 bit
    patterns with encode_v itself. The kernel's v encode counts the
    thresholds a frac reaches."""
    k = torch.arange(1, 256)
    lo = torch.zeros(255, dtype=torch.int64)                # code < k
    hi = torch.full((255,), 0x3F800000, dtype=torch.int64)  # 1.0: code 255
    while bool((hi - lo > 1).any()):
        mid = (lo + hi) // 2
        reach = _v_codes(mid.to(torch.int32).view(torch.float32)) >= k
        hi, lo = torch.where(reach, mid, hi), torch.where(reach, lo, mid)
    return tuple(hi.to(torch.int32).view(torch.float32).tolist())


@functools.lru_cache(maxsize=None)
def _thresholds_arg():
    return (ctypes.c_float * 255)(*v_code_thresholds())


def _moment_read(m, dtype: str, shape, signed: bool = True) -> Tensor:
    if dtype != "int8":
        return m
    return decode_m(m, shape) if signed else decode_v(m, shape)


def _moment_write(val: Tensor, dtype: str, signed: bool = True):
    if dtype != "int8":
        return val
    return encode_m(val) if signed else encode_v(val)


def _write_into(old, new):
    """Copy a leaf's new value (a tensor, or an int8 codec dict) into the
    old one's storage."""
    if isinstance(old, dict):
        for k in old:
            old[k].copy_(new[k])
    else:
        old.copy_(new)


# ---------------------------------------------------------------------------
# the leaf update
# ---------------------------------------------------------------------------

def adamw_leaf_plain(p: Tensor, g: Tensor, m_enc, v_enc, *, lr: Tensor,
                     c1: Tensor, c2: Tensor, cfg, factor=None) -> None:
    """The plain version, in place: p, and the moments (f32 tensors, or
    int8 codec dicts when `cfg.moment_dtype` is "int8"), take the update
    of gradient `g` (times the clip factor, a 0-d tensor, when given). A
    leaf of more than CHUNK entries is updated a slab of leading rows at a
    time: every quantity is elementwise or per last-dim block, so the
    slabs' results are the whole leaf's, and the temporaries (the codec's
    f64 roots among them) are a slab's (on the meta device, the dry
    run's, nothing is allocated: the whole leaf at once, which counts the
    same operations and bytes)."""

    def upd(p, g, m_enc, v_enc):
        g = g.float()
        if factor is not None:
            g = g * factor
        m = _moment_read(m_enc, cfg.moment_dtype, p.shape, True)
        v = _moment_read(v_enc, cfg.moment_dtype, p.shape, False)
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        new = ((p - lr * delta).to(p.dtype),
               _moment_write(m, cfg.moment_dtype, True),
               _moment_write(v, cfg.moment_dtype, False))
        for old, val in zip((p, m_enc, v_enc), new):
            _write_into(old, val)

    rows = p.shape[0] if p.dim() > 1 else 1
    step = max(1, CHUNK // max(1, p.numel() // rows))
    if rows <= step or p.device.type == "meta":
        upd(p, g, m_enc, v_enc)
        return
    cut = (lambda x, sl: {k: t[sl] for k, t in x.items()}
           if isinstance(x, dict) else x[sl])
    for r in range(0, rows, step):
        sl = slice(r, r + step)
        upd(p[sl], g[sl], cut(m_enc, sl), cut(v_enc, sl))


def _checked(name: str, t: Tensor, dev, dtype, shape, align: int = 1):
    if t.device != dev or t.dtype != dtype:
        raise TypeError(f"adamw: {name} must be {dtype} on {dev}, got "
                        f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"adamw: {name} must be contiguous {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"adamw: {name} must be {align}-byte aligned")
    return t.data_ptr()


def adamw_leaf_cuda(p: Tensor, g: Tensor, m_enc, v_enc, *, lr: Tensor,
                    c1: Tensor, c2: Tensor, cfg, factor=None) -> None:
    """Launch the kernel: the update of `adamw_leaf_plain`, in place, in
    one pass. p and g f32 of one shape; m, v f32 like p, or int8 codec
    dicts (`encode_m` / `encode_v` layout); lr, c1, c2 and factor
    0-d f32 on p's card."""
    global launches
    dev = p.device
    if dev.type != "cuda":
        raise RuntimeError(f"adamw kernel needs CUDA tensors, got {dev}")
    shape = tuple(p.shape)
    _checked("p", p, dev, torch.float32, shape)
    _checked("g", g, dev, torch.float32, shape)
    scalars = [_checked(n, t, dev, torch.float32, ())
               for n, t in (("lr", lr), ("c1", c1), ("c2", c2))]
    scalars.append(None if factor is None else
                   _checked("factor", factor, dev, torch.float32, ()))
    hyper = (cfg.b1, 1.0 - cfg.b1, cfg.b2, 1.0 - cfg.b2, cfg.eps,
             cfg.weight_decay)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = p.numel()
    if n == 0:
        raise ValueError("adamw: empty leaf")
    if cfg.moment_dtype != "int8":
        ptrs = [p.data_ptr(), g.data_ptr(),
                _checked("m", m_enc, dev, torch.float32, shape),
                _checked("v", v_enc, dev, torch.float32, shape)]
        vec = int(all(a % 16 == 0 for a in ptrs))
        fn = build.load(NAME, "adamw_f32", _F32_ARGTYPES)
        rc = fn(*ptrs, n, vec, *scalars, *hyper, stream)
    else:
        d = shape[-1] if shape else 1
        rows = n // d
        nb = -(-d // BLOCK)
        lead = shape[:-1]
        codes = (*lead, nb * BLOCK) if shape else (nb * BLOCK,)
        blocks = (*lead, nb) if shape else (1,)
        efs = (*lead, nb * BLOCK // 4) if shape else (nb * BLOCK // 4,)
        if not (isinstance(m_enc, dict) and "ef" in m_enc
                and isinstance(v_enc, dict)):
            raise TypeError("adamw: int8 moments must be codec dicts, the "
                            "first moment with its 'ef' codes")
        ptrs = [_checked("m.q", m_enc["q"], dev, torch.int8, codes, 8),
                _checked("m.scale", m_enc["scale"], dev, torch.float32,
                         blocks),
                _checked("m.ef", m_enc["ef"], dev, torch.uint8, efs, 2),
                _checked("v.q", v_enc["q"], dev, torch.uint8, codes, 8),
                _checked("v.scale", v_enc["scale"], dev, torch.float32,
                         blocks)]
        grid = min(-(-rows * nb // Q8_WARPS),
                   build.sm_count(dev.index) * Q8_BLOCKS_PER_SM)
        fn = build.load(NAME, "adamw_q8", _Q8_ARGTYPES)
        rc = fn(p.data_ptr(), g.data_ptr(), *ptrs, rows, d, nb, *scalars,
                *hyper, _thresholds_arg(), grid, stream)
    build.check(NAME, rc)
    launches += 1


PROBE_MODES = ("update", "encode")


def div_probe(divisors: Tensor, mode: str = "update"):
    """The int8 path's division against __fdiv_rn on the card, for each
    f32 divisor over all 2^32 f32 numerators. `mode` "update": the c1 /
    c2 quotients (a corrected multiply in range, __fdiv_rn out of it),
    mismatched where any bit differs; "encode": the codes' quotients (the
    corrected multiply unchecked, taken for a block scale in [2^-60,
    2^100]; other divisors are not probed) over the numerators within 256
    times the divisor (the codes' never pass 128 times their scale) and
    NaN, mismatched where any bit differs unless both are below 2^-40
    (codes 0). Returns (mismatches (n,) int64, the least mismatching
    numerator's bits (n,) int64, -1 where none), on the divisors' card.
    Not a main-path launch: it adds nothing to `launches`."""
    dev = divisors.device
    if dev.type != "cuda":
        raise RuntimeError(f"adamw division probe needs a CUDA tensor, got "
                           f"{dev}")
    n = divisors.numel()
    if not 0 < n <= 65535 or mode not in PROBE_MODES:
        raise ValueError(f"adamw: probe ({mode}) of {n} divisors")
    divisors = divisors.reshape(-1).contiguous()
    div = _checked("divisors", divisors, dev, torch.float32, (n,))
    bad = torch.zeros(n, dtype=torch.int64, device=dev)
    first = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fn = build.load(NAME, "adamw_div_probe", _PROBE_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(NAME, fn(div, n, PROBE_MODES.index(mode), bad.data_ptr(),
                         first.data_ptr(), stream))
    return bad, torch.where(bad > 0, first.long() & 0xffffffff, -1)
