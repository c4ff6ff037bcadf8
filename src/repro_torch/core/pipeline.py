"""Whole-model COMQ, dense staged path (port of `repro.core.pipeline`).

GPTQ-style sequential layer-by-layer quantization with quantized
propagation, on the staged schedule: one forward per layer quantizes each
leaf group in tap order (attn_in → wo_in → mlp_in → down_in) through the
model's `quantize_cb` hook, so every downstream tap is computed with the
already-quantized upstream sub-blocks. Each tap's Gram is computed once and
its leaves are solved (column-fused when that is exact). Per-leaf errors
stay on the device until one transfer at the end.

Not ported yet (ROADMAP.md): numeric guards (a healthy run is identical
with them off), the journal/resume path, fault injection, mixed-bit
policies, data/column sharding, tracing/metrics, the legacy two-forward
schedule, and the MoE/SSM/RWKV/VLM families.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import calibrate
from repro_torch.core.baselines import gptq_quantize, rtn_quantize
from repro_torch.core.comq_hessian import (comq_quantize_blocked,
                                           comq_quantize_h)
from repro_torch.core.quantizer import QuantSpec
from repro_torch.models import transformer as tfm

Tensor = torch.Tensor

# which tap feeds which weight leaf (dense family)
DENSE_TAPS = {
    ("attn", "wq"): "attn_in", ("attn", "wk"): "attn_in",
    ("attn", "wv"): "attn_in", ("attn", "wo"): "wo_in",
    ("mlp", "w_gate"): "mlp_in", ("mlp", "w_up"): "mlp_in",
    ("mlp", "w_down"): "down_in",
}


def taps_for(cfg) -> Dict[Tuple[str, str], str]:
    tfm.check_dense(cfg)
    return dict(DENSE_TAPS)


def is_qtensor(leaf) -> bool:
    return isinstance(leaf, dict) and bool(leaf.get("__qtensor__", False))


def make_qtensor(q: Tensor, delta: Tensor, z_lo: Tensor, shape,
                 bits: int = 8) -> dict:
    """Codes stored offset-binary (q - z_lo ∈ [0, 2^b-1]) as uint8;
    dequant restores W_q = δ·(u + z)."""
    return {"__qtensor__": True, "codes": (q - z_lo).to(torch.uint8),
            "scale": torch.as_tensor(delta, dtype=torch.float32),
            "z_lo": torch.as_tensor(z_lo, dtype=torch.int32),
            "shape": tuple(int(s) for s in shape),
            "bits": int(bits)}


def qtensor_bits(t: dict) -> int:
    return int(t.get("bits", 8))


def dequant_qtensor(t: dict, dtype=torch.float32) -> Tensor:
    q = t["codes"].to(torch.int32) + t["z_lo"]
    w2d = q.float() * t["scale"]
    return w2d.reshape(t["shape"]).to(dtype)


def dequantize_tree(tree):
    """Replace every QTensor leaf with its dequantized dense weight."""
    if is_qtensor(tree):
        return dequant_qtensor(tree)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(dequantize_tree(v) for v in tree)
    return tree


@dataclass
class LayerReport:
    layer: int
    name: str
    err_before: float     # ‖X(W - RTN(W))‖ on the COMQ grid init
    err_after: float      # ‖X(W - W_q)‖ after COMQ
    # host time spent dispatching this leaf's solve (the walk does not
    # wait for the device, so this is not its compute time)
    dispatch_seconds: float = 0.0


@dataclass
class QuantReport:
    layers: List[LayerReport] = field(default_factory=list)
    wall_seconds: float = 0.0   # whole walk, host clock, before the sync

    def total_improvement(self) -> float:
        b = sum(r.err_before for r in self.layers)
        a = sum(r.err_after for r in self.layers)
        return (b - a) / max(b, 1e-12)


# ---------------------------------------------------------------------------
# solver dispatch + shared-tap fused solves
# ---------------------------------------------------------------------------

def solve(h: Tensor, w2d: Tensor, spec: QuantSpec, method: str = "comq"):
    if method == "comq":
        return comq_quantize_h(h, w2d, spec)
    if method == "comq_blocked":
        return comq_quantize_blocked(h, w2d, spec)
    if method == "rtn":
        return rtn_quantize(w2d, spec, h=h)
    if method == "gptq":
        return gptq_quantize(h, w2d, spec)
    raise ValueError(f"unknown method {method!r}")


def _fusable(spec: QuantSpec, method: str) -> bool:
    """True when leaves sharing a tap can be solved as one column-
    concatenated matrix with results identical to per-leaf solves:
    per-channel grids with a per-column visit order."""
    if spec.granularity != "per_channel":
        return False
    if method == "comq_blocked":
        return spec.order == "cyclic"
    if method in ("rtn", "gptq"):
        return True
    return spec.order in ("cyclic", "greedy")


def _w2d(w: Tensor, m: int) -> Tensor:
    """2D view (m, cols) of a weight against tap feature dim m: attention
    (d, H, hd) flattens to (d, H·hd); wo (H, hd, d) to (H·hd, d)."""
    if w.dim() == 2:
        return w
    if w.dim() == 3 and w.shape[0] == m:
        return w.reshape(m, w.shape[1] * w.shape[2])
    if w.dim() == 3 and w.shape[0] * w.shape[1] == m:
        return w.reshape(m, w.shape[2])
    raise ValueError(f"cannot 2D-ify weight {tuple(w.shape)} for tap dim {m}")


def _col_err2(h: Tensor, w: Tensor, wq: Tensor) -> Tensor:
    """Per-column squared reconstruction error Σ_i R⊙(HR)."""
    r = w - wq
    return torch.sum(r * (h @ r), dim=0)


def _norm_of(e2: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp(torch.sum(e2), min=0.0))


def _solve_group(ws, h: Tensor, spec: QuantSpec, method: str):
    """Solve the weight leaves `ws`, all calibrated by the Gram h. When
    fusion is exact (`_fusable`) they are solved as one column-concatenated
    matrix and split back; otherwise each leaf solves alone (comq_blocked
    with the shared greedy order always does). Returns
    [(qtensor, err_before, err_after, seconds), ...]."""
    m = h.shape[0]
    w2ds = [_w2d(w, m) for w in ws]
    if len(ws) > 1 and _fusable(spec, method):
        t0 = time.time()
        wcat = torch.cat([w.float() for w in w2ds], dim=1)
        r = solve(h, wcat, spec, method)
        e2_after = _col_err2(h, wcat, r.q.float() * r.delta)
        rt = rtn_quantize(wcat, spec)
        e2_before = _col_err2(h, wcat, rt.q.float() * rt.delta)
        secs = (time.time() - t0) / len(ws)
        out, lo = [], 0
        for w, w2d in zip(ws, w2ds):
            hi = lo + w2d.shape[1]
            qt = make_qtensor(r.q[:, lo:hi], r.delta[lo:hi], r.z_lo[lo:hi],
                              w.shape, bits=spec.bits)
            out.append((qt, _norm_of(e2_before[lo:hi]),
                        _norm_of(e2_after[lo:hi]), secs))
            lo = hi
        return out
    out = []
    for w, w2d in zip(ws, w2ds):
        t0 = time.time()
        r = solve(h, w2d, spec, method)
        rt = rtn_quantize(w2d, spec, h=h)
        qt = make_qtensor(r.q, r.delta, r.z_lo, w.shape, bits=spec.bits)
        out.append((qt, rt.errors[-1], r.errors[-1], time.time() - t0))
    return out


def _tap_groups(lp, tapmap) -> Dict[str, List[Tuple[str, str]]]:
    """tapname -> [(mod, leaf), ...] for the leaves present in this layer."""
    groups: Dict[str, List[Tuple[str, str]]] = {}
    for (mod, leaf), tapname in tapmap.items():
        if mod in lp and leaf in lp[mod]:
            groups.setdefault(tapname, []).append((mod, leaf))
    return groups


def _set_nested(lp, mod, leaf, value):
    lp = dict(lp)
    lp[mod] = dict(lp[mod])
    lp[mod][leaf] = value
    return lp


def _staged_cb(lp, groups, taps, spec: QuantSpec, method: str,
               pending: List[tuple], layer_idx: int, holder: dict):
    """The staged `quantize_cb`: invoked by the model's tap hooks
    mid-forward, right after tap `tapname` is recorded. Solves the tap's
    leaf group, stashes the QTensors in `holder`, and returns dequantized
    replacements so the rest of the forward runs on the quantized
    sub-blocks."""
    def cb(tapname: str):
        entries = groups.get(tapname)
        if not entries:
            return {}
        ws = [lp[mod][leaf] for mod, leaf in entries]
        h = calibrate.gram_from_tap(taps[tapname])
        repl = {}
        for (mod, leaf), (qt, eb, ea, secs) in zip(
                entries, _solve_group(ws, h, spec, method)):
            holder["lp_q"] = _set_nested(holder["lp_q"], mod, leaf, qt)
            pending.append((layer_idx, f"{mod}.{leaf}", eb, ea, secs))
            repl[leaf] = dequant_qtensor(qt)
        return repl
    return cb


def _quantize_layer_staged(lp, x, cfg, plan, tapmap, spec, method: str,
                           pending: List[tuple], layer_idx: int):
    """One `layer_full` evaluation quantizes the layer in tap order and
    propagates x through the quantized sub-blocks. Returns (lp_q, new_x)."""
    taps: Dict[str, Tensor] = {}
    holder = {"lp_q": lp}
    cb = _staged_cb(lp, _tap_groups(lp, tapmap), taps, spec, method,
                    pending, layer_idx, holder)
    y, _ = tfm.layer_full(lp, x, cfg, plan, False, taps=taps, quantize_cb=cb)
    return holder["lp_q"], y


def _finalize_report(report: QuantReport, pending: List[tuple]):
    """Move every per-leaf error scalar to the host in one transfer."""
    if not pending:
        return report
    errs = torch.stack([torch.stack([torch.as_tensor(eb).float(),
                                     torch.as_tensor(ea).float()])
                        for (_, _, eb, ea, _) in pending]).cpu().tolist()
    for (li, name, _, _, secs), (eb, ea) in zip(pending, errs):
        report.layers.append(LayerReport(li, name, float(eb), float(ea),
                                         secs))
    return report


def _calib_leaf_dims(cfg) -> Dict[str, int]:
    return {"d_model": cfg.d_model,
            "wo_in": cfg.n_heads * cfg.resolved_head_dim,
            "down_in": cfg.d_ff}


def quantize_model(params, cfg, plan, tokens: Tensor, spec: QuantSpec,
                   method: str = "comq"):
    """Quantize every projection weight of a dense LM on the staged
    schedule. `tokens`: (B, T) calibration batch on the params' device.

    Returns (qparams, QuantReport): qparams is `params` plus a
    "__qlayers__" side table {str(layer): layer params with QTensor
    leaves}; use `materialize` (dense) or `core.apply.serving_params`
    (packed) to run it."""
    from repro_torch.data import check_calib_coverage, validate_calib_tokens
    from repro_torch.models.model import embed_tokens
    if not isinstance(spec, QuantSpec):
        raise NotImplementedError(
            "per-leaf quantization policies are not ported to repro_torch "
            "yet; pass a QuantSpec")
    tapmap = taps_for(cfg)
    validate_calib_tokens(tokens, vocab_size=cfg.vocab_size)
    check_calib_coverage(int(tokens.shape[0]) * int(tokens.shape[1]),
                         _calib_leaf_dims(cfg))

    t_start = time.time()
    report = QuantReport()
    pending: List[tuple] = []
    table = {}
    with torch.no_grad():
        x = embed_tokens(params, cfg, plan, tokens)
        for l, lp in enumerate(params["layers"]):
            lp_q, x = _quantize_layer_staged(lp, x, cfg, plan, tapmap, spec,
                                             method, pending, l)
            table[str(l)] = lp_q
    qparams = dict(params)
    qparams["__qlayers__"] = table
    _finalize_report(report, pending)
    report.wall_seconds = time.time() - t_start
    return qparams, report


# ---------------------------------------------------------------------------
# materialize a runnable dequantized model
# ---------------------------------------------------------------------------

def materialize(qparams, cfg) -> Any:
    """Fold the __qlayers__ side table back into dense per-layer params."""
    params = {k: v for k, v in qparams.items() if k != "__qlayers__"}
    table = qparams.get("__qlayers__", {})
    if not table:
        return params
    dense = params.get("layers")
    layers = []
    for i, key in enumerate(sorted(table, key=int)):
        deq = dequantize_tree(table[key])
        if dense is not None:
            deq = _match_dtypes(deq, dense[i])
        layers.append(deq)
    params["layers"] = layers
    if is_qtensor(params.get("unembed")):
        params["unembed"] = dequant_qtensor(params["unembed"])
    return params


def _match_dtypes(tree, like):
    if isinstance(tree, dict):
        return {k: _match_dtypes(v, like[k]) for k, v in tree.items()}
    return tree.to(like.dtype)
