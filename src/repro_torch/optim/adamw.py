"""AdamW with optional 8-bit (blockwise-quantized) moments (port of
`repro.optim.adamw`; plain PyTorch, the same state tree and key names, so
`CheckpointManager` step directories read both ways).

The 8-bit moment state (per-block absmax scales, block=256) cuts optimizer
memory from 8 to ~2.3 bytes/param. Rounding is deterministic (round half
to even, as `jnp.round`); the update math runs in f32 after decoding.

The signed first moment carries *error feedback*: the int8 rounding
residual (≤ scale/2 per element) is re-quantized to 2-bit codes on the
same block scale and stored packed 4-per-byte next to the int8 codes
("ef"), and decoding adds it back, so the EMA m ← β₁·decode(m) + (1−β₁)·g
runs on a value within scale/6 of the exact f32 moment and the int8 run
does not walk off the f32 one. The non-negative second moment keeps the
power-law codec ((v/absmax)^(1/4) on 255 levels), EF-free.

The JAX package chains the leaf updates with `optimization_barrier` only
to bound live temporaries; eager PyTorch updates one leaf at a time
already, so the leaves are written in order and no token is computed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

Tensor = torch.Tensor
PyTree = Any

BLOCK = 256
# the in-place update's slab: a larger leaf is updated CHUNK entries at a
# time (whole rows), which bounds its temporaries
CHUNK = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"      # float32 | int8


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


def _pack2(c: Tensor) -> Tensor:
    """{0..3} codes (last dim % 4 == 0) packed 4-per-uint8, low pair first."""
    c4 = c.to(torch.uint8).reshape(*c.shape[:-1], -1, 4)
    return (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
            | (c4[..., 3] << 6))


def _unpack2(b: Tensor) -> Tensor:
    parts = torch.stack([(b >> (2 * i)) & 3 for i in range(4)], dim=-1)
    return parts.reshape(*b.shape[:-1], b.shape[-1] * 4)


def _q8_encode(x: Tensor) -> Dict[str, Tensor]:
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
            "ef": _pack2(eq.reshape(xp.shape))}


def _q8_decode(enc: Dict[str, Tensor], shape) -> Tensor:
    q = enc["q"]
    blocks = q.reshape(*q.shape[:-1], -1, BLOCK).float()
    x = blocks * enc["scale"][..., None]
    if "ef" in enc:                                # error-feedback add-back
        eq = _unpack2(enc["ef"]).float() - 2.0
        x = x + (eq.reshape(*q.shape[:-1], -1, BLOCK)
                 * _div(enc["scale"][..., None], 3.0))
    x = x.reshape(q.shape)
    d = shape[-1] if len(shape) else 1
    return x[..., :d].reshape(shape)


def _q8_encode_pow(x: Tensor) -> Dict[str, Tensor]:
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


def _q8_decode_pow(enc: Dict[str, Tensor], shape) -> Tensor:
    q = enc["q"]
    blocks = _div(q.reshape(*q.shape[:-1], -1, BLOCK).float(), 255.0)
    frac = torch.square(torch.square(blocks))
    x = (frac * enc["scale"][..., None]).reshape(q.shape)
    d = shape[-1] if len(shape) else 1
    return x[..., :d].reshape(shape)


def _moment_init(p: Tensor, dtype: str, signed: bool = True):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if dtype != "int8":
        return z
    return _q8_encode(z) if signed else _q8_encode_pow(z)


def _moment_read(m, dtype: str, shape, signed: bool = True) -> Tensor:
    if dtype != "int8":
        return m
    return _q8_decode(m, shape) if signed else _q8_decode_pow(m, shape)


def _moment_write(val: Tensor, dtype: str, signed: bool = True):
    if dtype != "int8":
        return val
    return _q8_encode(val) if signed else _q8_encode_pow(val)


def _is_enc(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


# ---------------------------------------------------------------------------


def adamw_init(params: PyTree, cfg: AdamWConfig) -> Dict[str, Any]:
    step_dev = pytree.tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=step_dev),
        "m": pytree.tree_map(
            lambda p: _moment_init(p, cfg.moment_dtype, True), params),
        "v": pytree.tree_map(
            lambda p: _moment_init(p, cfg.moment_dtype, False), params),
    }


def _write_into(old, new):
    """Copy a leaf's new value (a tensor, or an int8 codec dict) into the
    old one's storage."""
    if isinstance(old, dict):
        for k in old:
            old[k].copy_(new[k])
    else:
        old.copy_(new)


def _update(grads: PyTree, state: Dict[str, Any], params: PyTree,
            cfg: AdamWConfig, lr, inplace: bool
            ) -> Tuple[PyTree, Dict[str, Any]]:
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                      device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                      device=t.device), t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)

    def upd(p, g, m_enc, v_enc):
        g = g.float()
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
        if not inplace:
            return new
        for old, val in zip((p, m_enc, v_enc), new):
            _write_into(old, val)
        return p, m_enc, v_enc

    def upd_rows(p, g, m_enc, v_enc):
        # in place, a leaf of more than CHUNK entries is updated a slab of
        # leading rows at a time: every quantity is elementwise or per
        # last-dim block, so the slabs' results are the whole leaf's, and
        # the temporaries (the codec's f64 roots among them) are a slab's
        rows = p.shape[0] if p.dim() > 1 else 1
        step = max(1, CHUNK // max(1, p.numel() // rows))
        if not inplace or rows <= step:
            return upd(p, g, m_enc, v_enc)
        cut = (lambda x, sl: {k: t[sl] for k, t in x.items()}
               if isinstance(x, dict) else x[sl])
        for r in range(0, rows, step):
            sl = slice(r, r + step)
            upd(p[sl], g[sl], cut(m_enc, sl), cut(v_enc, sl))
        return p, m_enc, v_enc

    flat_p, pdef = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(grads)
    flat_m, mdef = pytree.tree_flatten(state["m"], is_leaf=_is_enc)
    flat_v = pytree.tree_leaves(state["v"], is_leaf=_is_enc)
    out = [upd_rows(*a) for a in zip(flat_p, flat_g, flat_m, flat_v)]
    return (pytree.tree_unflatten([o[0] for o in out], pdef),
            {"step": step,
             "m": pytree.tree_unflatten([o[1] for o in out], mdef),
             "v": pytree.tree_unflatten([o[2] for o in out], mdef)})


def adamw_update(grads: PyTree, state: Dict[str, Any], params: PyTree,
                 cfg: AdamWConfig, lr) -> Tuple[PyTree, Dict[str, Any]]:
    """Returns (new_params, new_state). Master params stay f32; the inputs
    are left as they were, as JAX's arrays are."""
    return _update(grads, state, params, cfg, lr, inplace=False)


def adamw_update_(grads: PyTree, state: Dict[str, Any], params: PyTree,
                  cfg: AdamWConfig, lr) -> Tuple[PyTree, Dict[str, Any]]:
    """`adamw_update` for a caller that owns `state` and `params` (the
    train step, as JAX's `donate_argnums=(0,)` gives its jitted step):
    each leaf's new param and moments are written into its tensors as soon
    as they are computed, a slab of at most CHUNK entries at a time, so
    the update holds one slab's temporaries instead of a second copy of
    the state. Returns the same trees, with a
    new step counter."""
    return _update(grads, state, params, cfg, lr, inplace=True)


def global_norm(tree: PyTree) -> Tensor:
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_global_norm(tree: PyTree, max_norm: float
                        ) -> Tuple[PyTree, Tensor]:
    norm = global_norm(tree)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return pytree.tree_map(lambda g: g * factor, tree), norm
