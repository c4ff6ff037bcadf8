"""Quantized parameter containers for the serving path (port of
`repro.core.apply`).

`QT` holds packed codes, per-channel scale and zero-point, and the leaf's
logical shape and bit width. `serving_params` turns a `quantize_model`
output into per-layer params with QT leaves; the decode path feeds the
fused-layout QT projections to `quant_matmul` (`qt_linear`), so the card
streams 4-bit codes instead of bf16 weights. Layers are a per-layer list
in the port, so a per-layer bit width needs no scan segments.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.pipeline import is_qtensor, qtensor_bits
from repro_torch.core.quantizer import pack_codes, unpack_codes

Tensor = torch.Tensor


def _default_cpb(bits: int) -> int:
    return 2 if bits == 4 else 1


class QT:
    """Quantized tensor: codes (uint8, packed `cpb` codes per byte),
    per-channel scale + zero-point; logical shape + bit width."""

    def __init__(self, codes: Tensor, scale: Tensor, z_lo: Tensor,
                 shape: Tuple[int, ...], bits: int,
                 cpb: Optional[int] = None):
        self.codes = codes
        self.scale = scale
        self.z_lo = z_lo
        self.shape = tuple(int(s) for s in shape)
        self.bits = int(bits)
        self.cpb = _default_cpb(self.bits) if cpb is None else int(cpb)

    def dequant(self, dtype=torch.bfloat16) -> Tensor:
        u = unpack_codes(self.codes, self.cpb)
        s, z = self.scale, self.z_lo
        if u.dim() == s.dim() + 1:   # per-channel scale over the last dim
            s = s[..., None, :]
            z = z[..., None, :]
        w = (u.float() + z.float()) * s
        if tuple(w.shape) != self.shape:
            target = _suffix_shape(self.shape, w.numel())
            if target is not None:
                w = w.reshape(target)
        return w.to(dtype)


def is_qt(x) -> bool:
    return isinstance(x, QT)


def _suffix_shape(shape, size):
    """Shortest suffix of `shape` whose element count equals `size`."""
    for i in range(len(shape), -1, -1):
        if math.prod(shape[i:]) == size:
            return tuple(shape[i:])
    return None


def qt_out_dims(qt: QT):
    """Logical trailing dims of a 2D-codes QT's output axis (the (H, hd)
    of a wq whose codes are stored (d, H·hd)); longest valid suffix."""
    n = qt.codes.shape[-1] * qt.cpb
    k = qt.codes.shape[0]
    shp = qt.shape
    for i in range(len(shp)):
        if math.prod(shp[i:]) != n:
            continue
        if any(math.prod(shp[j:i]) == k for j in range(i)):
            return tuple(shp[i:])
    return (n,)


def qt_fusable(x) -> bool:
    """2D codes (tap_dim, cols) with one per-column scale: the layout
    quant_matmul consumes directly."""
    return is_qt(x) and x.codes.dim() == 2 and x.scale.dim() == 1


def qt_linear(qt: QT, x2d: Tensor, out_dtype=None) -> Tensor:
    """x2d (M, K) · QT codes (K, N) through `quant_matmul` (f32 and bf16
    x go in as they are, any other type as f32; the f32 result is cast to
    `out_dtype`)."""
    from repro_torch.kernels import ops
    x = x2d if x2d.dtype in (torch.float32, torch.bfloat16) else x2d.float()
    y = ops.quant_matmul(x.contiguous(), qt.codes, qt.scale.float(),
                         qt.z_lo.float(), cpb=qt.cpb)
    return y.to(out_dtype if out_dtype is not None else x2d.dtype)


# leaves whose apply sites (qkv_project / out_project / apply_mlp) consume a
# fused-layout QT directly
FUSED_QT_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def dequantize_qt_tree(tree, dtype=torch.bfloat16, keep_fused: bool = False):
    """Replace QT leaves with dense weights; keep_fused=True keeps the
    fusable projection leaves packed (the decode path)."""
    def walk(node, name=""):
        if is_qt(node):
            if keep_fused and name in FUSED_QT_LEAVES and qt_fusable(node):
                return node
            return node.dequant(dtype)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return node

    return walk(tree)


def fake_quantize_params(params, cfg, plan, bits: int = 4,
                         quantize_embed: bool = True):
    """Wrap every projection weight (and the embedding, unless
    quantize_embed=False) in a QT with RTN codes — the layout transform of
    a serving dry run; real deployments load COMQ codes. Per-channel over
    the last dim, one grid per slice of the leading dims, as the JAX
    package does for its stacked layers. Walks any params tree (a VLM's
    groups, an encoder's layers)."""
    from repro_torch.core.quantizer import init_per_channel, quantize_rtn

    def to_qt(w):
        shape = tuple(w.shape)
        lead = shape[:-2]
        w3 = w.reshape(-1, *shape[-2:]).float()           # (S, rows, cols)
        cols = w3.shape[-1]
        # one per-channel grid per slice (S, cols)
        deltas, zs, z_hi = init_per_channel(w3, bits, 1.0)
        u = (quantize_rtn(w3, deltas[:, None], zs[:, None], z_hi[:, None])
             - zs[:, None]).to(torch.uint8)
        us, cpb = pack_codes(u, bits)
        if lead:
            us = us.reshape(*lead, *us.shape[1:])
            deltas, zs = deltas.reshape(*lead, cols), zs.reshape(*lead, cols)
        else:
            us, deltas, zs = us[0], deltas[0], zs[0]
        return QT(us, deltas, zs, shape, bits, cpb=cpb)

    # the JAX package's list: RWKV's projections, hymba's SSM w_in, w_out
    # and w_xproj, the unembedding
    quantizable = set(FUSED_QT_LEAVES) | {"w_r", "w_k", "w_v", "w_g", "w_o",
                                          "w_in", "w_out", "w_xproj",
                                          "unembed"}
    if quantize_embed:
        quantizable.add("embed")

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if name in quantizable and isinstance(node, Tensor) \
                and node.dim() >= 2:
            return to_qt(node)
        return node

    return walk(params)


def _fit_spec(spec, rank: int, drop_last: bool = False):
    """A dense leaf's spec fitted to a QT part of `rank` dims (JAX's
    `_fit_spec`): trailing entries of flattened dims collapse to the
    last one, missing ones are None; `drop_last` replicates the last."""
    from repro_torch.dist.sharding import PartitionSpec
    entries = list(spec)
    if len(entries) > rank:
        entries = entries[:rank - 1] + [entries[-1]]
    while len(entries) < rank:
        entries.append(None)
    if drop_last and entries:
        entries[-1] = None
    return PartitionSpec(*entries)


def qt_spec(qt: QT, spec) -> QT:
    """The QT of specs for one QT leaf whose dense spec is `spec`: the
    codes inherit it (same rank; the packed last dim splits the same
    way), scale and zero-point drop the last-dim axis (they are tiny)."""
    return QT(_fit_spec(spec, qt.codes.dim()),
              _fit_spec(spec, qt.scale.dim(), drop_last=True),
              _fit_spec(spec, qt.z_lo.dim(), drop_last=True), qt.shape,
              qt.bits, cpb=qt.cpb)


def qt_param_specs(qparams, dense_specs):
    """Shardings for a QT-bearing tree from the dense params' specs
    (JAX's `qt_param_specs`): each QT leaf by `qt_spec`, every other leaf
    its dense spec."""
    def walk(q, s):
        if isinstance(q, dict):
            return {k: walk(q[k], s[k]) for k in q}
        if isinstance(q, (list, tuple)) and not is_qt(q):
            return type(q)(walk(a, b) for a, b in zip(q, s))
        return qt_spec(q, s) if is_qt(q) else s
    return walk(qparams, dense_specs)


def qt_from_qtensor(t: dict) -> QT:
    """One pipeline QTensor (offset-binary uint8 codes, f32 per-column
    scales, int32 zero-points) -> a QT packed to its recorded width."""
    bits = qtensor_bits(t)
    codes, cpb = pack_codes(t["codes"], bits)
    return QT(codes, t["scale"], t["z_lo"], tuple(t["shape"]), bits, cpb=cpb)


def serving_params(qparams, cfg):
    """Fold a quantize_model output (__qlayers__ QTensor side table) into
    per-layer params with QT leaves — the packed serving form. No dense
    copy of a quantized weight is built. A VLM's group table raises, as in
    the JAX package: `materialize` it."""
    params = {k: v for k, v in qparams.items() if k != "__qlayers__"}
    for k, v in list(params.items()):
        if is_qtensor(v):
            params[k] = qt_from_qtensor(v)
    table = qparams.get("__qlayers__", {})
    if not table:
        return params
    if cfg.family == "vlm":
        raise NotImplementedError(
            "packed-QT serving covers homogeneous stacks; materialize() "
            "the VLM group table instead")

    def walk(node):
        if is_qtensor(node):
            return qt_from_qtensor(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    params["layers"] = [walk(table[k]) for k in sorted(table, key=int)]
    return params
