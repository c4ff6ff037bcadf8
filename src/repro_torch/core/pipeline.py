"""Whole-model COMQ: the dense (and audio), MoE, hybrid, RWKV and VLM
families (port of `repro.core.pipeline`).

GPTQ-style sequential layer-by-layer quantization with quantized
propagation. Two schedules:

* ``staged`` (default): one forward per layer quantizes each leaf group in
  tap order (attn_in → wo_in → mlp_in → down_in) through the model's
  `quantize_cb` hook, so every downstream tap is computed with the
  already-quantized upstream sub-blocks;
* ``legacy``: a float forward collects the layer's taps, all its leaves
  are solved, and a second forward propagates through the quantized
  layer.

Each tap's Gram is computed once; a stacked-expert tap (E, C, d) gives one
Gram per expert, and its leaves (E, d, f) solve every expert at once
(`_solve_group_experts`, one `comq_panel` launch a panel for all
experts). A hybrid layer (hymba) adds the SSM branch's taps, ssm_in
(feeds w_in) and ssm_out_in (feeds w_out), and the walk carries the SSM
state from layer to layer as the JAX walk does: layer l+1 starts from
layer l's final state (`forward` starts every layer from zeros; ROADMAP,
"Known behaviours of the reference"). An RWKV layer has its own eight
taps (RWKV_TAPS: time-mix r / k / v / g / o, channel-mix k / r / v) and
the walk carries its RWKVState (token shifts and wkv state) the same
way. A VLM walks its groups: each self layer as a dense one (layer index
g·every + s), then the group's cross layer (index g·every + every-1) on
its own taps (CROSS_TAPS: xattn.wq, xattn.wo and the MLP; its wk / wv read
the image and stay float), its leaves named with the "cross." prefix.
Every leaf is solved under the spec a
`core.policy.QuantPolicy` resolves for it (a plain QuantSpec is the
uniform policy); a group whose specs agree is column-fused when that is
exact, a mixed-bit group solves leaf by leaf. With guards on (the
default) the numeric guards of core/guards.py sanitize taps, Grams and
weights and escalate failed solves; a healthy run gives the same codes as
guards=False. Per-leaf errors stay on the device until one transfer at the
end, unless the run is journaled.

Crash safety (`_RunCtx`): with a journal every solved tap group is pulled
to the host once, each leaf spilled atomically and then journaled
(ft/journal.QuantJournal); a resumed run re-applies a group's journaled
leaves through the same callback, skipping its Gram and solve, so the
forward, every later tap and every later solve repeat the uninterrupted
run's bit for bit. A fault injector (ft/inject.FaultInjector) arms the
pipeline's fault points (gram_accumulate, leaf_solve, ckpt_write, kill
between layers, nan_tap).

Observability (`_RunCtx`, as in the JAX package): with an obs.Tracer each
layer runs under a `layer` span and each tap group's solve under a
`leaf_solve` span (`device=True`: a `torch.profiler` user annotation
around its kernels); the span waits for the group's codes before it
closes, which gives LayerReport.wall_seconds. Without a tracer the walk
adds no sync and wall_seconds is 0.0. An obs.MetricsRegistry counts
layers, solved, resumed leaves and guard events, and observes each leaf's
error and seconds from the report's host values.

Distribution (`mesh`, a DeviceMesh over the SPMD ranks; repro_torch.dist),
as in the JAX package: the calibration batch is sharded over "data", each
rank walks its own rows and every tap's Gram is summed with one
all-reduce; an MoE layer routes globally over the data group, so the kept
(token, slot) set is the replicated walk's. With a nontrivial "model"
axis the per-channel comq_blocked / rtn solves are column-sharded
(`dist.sharded_solve`: each column the replicated solve's arithmetic,
one gather after each), and a sharded group whose result is non-finite is
redone replicated under the guards. Expert leaves solve replicated. A
metrics registry counts the all-reduced Gram bytes
(`dist.bytes_all_reduced`). Every rank reads a journal; rank 0 alone
writes it.

The encoder has no walk, as in the JAX package (its `quantize_model`
starts from `embed_tokens`).
"""
from __future__ import annotations

import json
import sys
import time
import zlib
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import calibrate
from repro_torch.core import guards as _guards
from repro_torch.core.baselines import gptq_quantize, rtn_quantize
from repro_torch.core.comq import QuantResult
from repro_torch.core.comq_hessian import (comq_quantize_blocked,
                                           comq_quantize_blocked_experts,
                                           comq_quantize_h, per_expert,
                                           rtn_experts)
from repro_torch.core.guards import GuardContext, GuardEvent, guarded_solve
from repro_torch.core.policy import as_policy, policy_to_dict
from repro_torch.core.quantizer import QuantSpec
from repro_torch.ft.inject import InjectedFault, SimulatedKill
from repro_torch.ft.journal import QuantJournal, ResumeMismatch
from repro_torch.models import transformer as tfm
from repro_torch.models.common import apply_norm
from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.obs.trace import NULL_TRACER

Tensor = torch.Tensor

# which tap feeds which weight leaf, per layer family
DENSE_TAPS = {
    ("attn", "wq"): "attn_in", ("attn", "wk"): "attn_in",
    ("attn", "wv"): "attn_in", ("attn", "wo"): "wo_in",
    ("mlp", "w_gate"): "mlp_in", ("mlp", "w_up"): "mlp_in",
    ("mlp", "w_down"): "down_in",
}
MOE_TAPS = {
    ("attn", "wq"): "attn_in", ("attn", "wk"): "attn_in",
    ("attn", "wv"): "attn_in", ("attn", "wo"): "wo_in",
    ("moe", "w_gate"): "expert_in", ("moe", "w_up"): "expert_in",
    ("moe", "w_down"): "expert_down_in",
}
RWKV_TAPS = {
    ("tm", "w_r"): "tm_r_in", ("tm", "w_k"): "tm_k_in",
    ("tm", "w_v"): "tm_v_in", ("tm", "w_g"): "tm_g_in",
    ("tm", "w_o"): "tm_o_in",
    ("cm", "w_k"): "cm_k_in", ("cm", "w_r"): "cm_r_in",
    ("cm", "w_v"): "cm_v_in",
}
SSM_EXTRA_TAPS = {
    ("ssm", "w_in"): "ssm_in", ("ssm", "w_out"): "ssm_out_in",
}
CROSS_TAPS = {
    ("xattn", "wq"): "xattn_q_in", ("xattn", "wo"): "xattn_wo_in",
    ("mlp", "w_gate"): "mlp_in", ("mlp", "w_up"): "mlp_in",
    ("mlp", "w_down"): "down_in",
}


def taps_for(cfg) -> Dict[Tuple[str, str], str]:
    tfm.check_ported(cfg)
    if cfg.attn_free:
        return dict(RWKV_TAPS)
    t = dict(MOE_TAPS if cfg.moe is not None else DENSE_TAPS)
    if cfg.parallel_ssm_heads:
        t.update(SSM_EXTRA_TAPS)
    return t


def layer_with_state(lp, x, state, cfg, plan, vision_kv=None, **kw):
    """`layer_full` (no cache) from the walk's recurrent state: returns
    (y, the layer's final state). The walk starts from None (a hybrid or
    RWKV layer's zero state); a state is passed on only once a layer
    returned one, so the other families call `layer_full` exactly as
    before. With `vision_kv` the layer is a VLM cross layer
    (`cross_layer_full`; no state)."""
    if vision_kv is not None:
        return tfm.cross_layer_full(lp, x, cfg, plan, vision_kv, **kw), None
    if state is not None:
        kw["rwkv_state" if cfg.attn_free else "ssm_state"] = state
    out = tfm.layer_full(lp, x, cfg, plan, False, **kw)
    return out[0], out[3]


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
    # the leaf's solve wall time (dispatch + device), from its tap group's
    # `leaf_solve` span, which waits for the codes before it closes; split
    # evenly across a group like dispatch_seconds. Only measured with a
    # tracer: 0.0 (unmeasured) on an untraced, sync-free walk
    wall_seconds: float = 0.0
    # comma-joined guard-event kinds for this leaf ("" = no intervention)
    guard: str = ""

    @property
    def seconds(self) -> float:
        """The JAX package's alias of dispatch_seconds (not wall time)."""
        return self.dispatch_seconds


@dataclass
class QuantReport:
    layers: List[LayerReport] = field(default_factory=list)
    wall_seconds: float = 0.0   # whole walk, host clock, before the sync
    # every numeric-guard intervention of the run (core/guards.GuardEvent);
    # empty on a healthy run
    guard_events: List[GuardEvent] = field(default_factory=list)
    # leaves re-applied from the journal instead of solved
    resumed_leaves: int = 0

    def total_improvement(self) -> float:
        b = sum(r.err_before for r in self.layers)
        a = sum(r.err_after for r in self.layers)
        return (b - a) / max(b, 1e-12)


# ---------------------------------------------------------------------------
# solver dispatch + shared-tap fused solves
# ---------------------------------------------------------------------------

def solve(h: Tensor, w2d: Tensor, spec: QuantSpec, method: str = "comq",
          block: int = 256, schedule: Optional[str] = None):
    """`schedule` applies to comq_blocked only (None = trailing); the
    guards' fallback chain retries a failed trailing solve on the
    per-panel-refresh schedule."""
    if method == "comq":
        return comq_quantize_h(h, w2d, spec)
    if method == "comq_blocked":
        return comq_quantize_blocked(h, w2d, spec, block=block,
                                     schedule=schedule or "trailing")
    if method == "rtn":
        return rtn_quantize(w2d, spec, h=h)
    if method == "gptq":
        return gptq_quantize(h, w2d, spec)
    raise ValueError(f"unknown method {method!r}")


def _col_shardable(spec: QuantSpec, method: str) -> bool:
    """True when the solve can run with W's output columns sharded over the
    "model" mesh axis as the replicated solve does: per-channel
    grids and a solver whose columns are independent given the shared
    visit order (blocked, with the order from the full W passed in) or
    elementwise (RTN). The row-at-a-time solvers stay replicated, as in
    the JAX package."""
    if spec.granularity != "per_channel":
        return False
    return method in ("comq_blocked", "rtn")


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


def _expert_norm_sum(e2: Tensor) -> Tensor:
    """(E, cols) per-column err² -> the sum over experts of each expert's
    error norm (a leaf's MoE error, as the JAX package reports it)."""
    return torch.sum(torch.sqrt(torch.clamp(torch.sum(e2, dim=1), min=0.0)))


def _uniform(specs) -> bool:
    return all(s == specs[0] for s in specs)


def _results_finite(results) -> bool:
    """Every (qt, eb, ea, secs) row has finite scales and errors: one host
    read (the expert group's post-solve guard sentinel)."""
    flags = [torch.isfinite(qt["scale"]).all()
             & torch.isfinite(torch.as_tensor(eb, dtype=torch.float32))
             & torch.isfinite(torch.as_tensor(ea, dtype=torch.float32))
             for qt, eb, ea, _ in results]
    return bool(torch.stack(flags).all())


def _solve_group(ws, h: Tensor, specs, method: str, block: int = 256,
                 solve_sh=None, *, gctx: Optional[GuardContext] = None,
                 layer: int = -1, names=None):
    """Solve the weight leaves `ws`, all calibrated by the Gram h, each
    under its own resolved spec (`specs`, same length).

    When the specs agree and fusion is exact (`_fusable`) the leaves are
    solved as one column-concatenated matrix and split back; otherwise
    each leaf solves alone — a mixed-bit group always does, since the grid
    init depends on the width. With an enabled `gctx` one health check
    sanitizes non-finite values in H and the weights and counts dead Gram
    columns, and the solves go through `guarded_solve`; a healthy group
    runs the unguarded computation.

    `solve_sh` (from quantize_model when the mesh has a "model" axis
    above 1) runs the solve column-sharded (`dist.sharded_solve`) with the
    replicated path's fusion decision, so both give the same codes at
    every width; with the guards on, a sharded group whose result is not
    finite is redone replicated under the guarded solve (a
    `sharded_solve_nonfinite` event per leaf). Returns
    [(qtensor, err_before, err_after, seconds), ...]."""
    m = h.shape[0]
    w2ds = [_w2d(w, m) for w in ws]
    spec0 = specs[0]
    guarding = gctx is not None and gctx.enabled
    if names is None:
        names = [f"leaf{i}" for i in range(len(ws))]
    if guarding:
        n_bad_h, n_dead, n_bad_ws = _guards.gram_health(h, w2ds)
        if n_bad_h:
            h = _guards.zero_nonfinite(h)
            for nm in names:
                gctx.record(layer, nm, "nonfinite_gram", count=n_bad_h)
        for i, (nb, nm) in enumerate(zip(n_bad_ws, names)):
            if nb:
                w2ds[i] = _guards.zero_nonfinite(w2ds[i])
                gctx.record(layer, nm, "nonfinite_weight", count=nb)
        if n_dead:
            for nm in names:
                gctx.record(layer, nm, "dead_columns", warn=False,
                            count=n_dead)

    if solve_sh is not None and _col_shardable(spec0, method):
        fuse = len(ws) > 1 and _uniform(specs) and _fusable(spec0, method)
        if fuse:
            t0 = time.time()
            wcat = torch.cat([w.float() for w in w2ds], dim=1)
            q, delta, z_lo, e2b, e2a = solve_sh(h, wcat, spec=spec0,
                                                block=block)
            secs = (time.time() - t0) / len(ws)
            out, lo = [], 0
            for w, w2d in zip(ws, w2ds):
                hi = lo + w2d.shape[1]
                qt = make_qtensor(q[:, lo:hi], delta[lo:hi], z_lo[lo:hi],
                                  w.shape, bits=spec0.bits)
                out.append((qt, _norm_of(e2b[lo:hi]), _norm_of(e2a[lo:hi]),
                            secs))
                lo = hi
        else:
            out = []
            for w, w2d, spec in zip(ws, w2ds, specs):
                t0 = time.time()
                q, delta, z_lo, e2b, e2a = solve_sh(h, w2d, spec=spec,
                                                    block=block)
                qt = make_qtensor(q, delta, z_lo, w.shape, bits=spec.bits)
                out.append((qt, _norm_of(e2b), _norm_of(e2a),
                            time.time() - t0))
        if guarding and not _results_finite(out):
            # the sharded solve has no guard hooks: redo the group
            # replicated under the guarded chain
            for nm in names:
                gctx.record(layer, nm, "sharded_solve_nonfinite")
            return _solve_group(ws, h, specs, method, block, None,
                                gctx=gctx, layer=layer, names=names)
        return out

    if len(ws) > 1 and _uniform(specs) and _fusable(spec0, method):
        t0 = time.time()
        wcat = torch.cat([w.float() for w in w2ds], dim=1)
        if guarding:
            r = guarded_solve(h, wcat, spec0, method, block=block, gctx=gctx,
                              layer=layer, names=names, solve_fn=solve,
                              presanitized=True)
        else:
            r = solve(h, wcat, spec0, method, block=block)
        e2_after = _col_err2(h, wcat, r.q.float() * r.delta)
        rt = rtn_quantize(wcat, spec0)
        e2_before = _col_err2(h, wcat, rt.q.float() * rt.delta)
        secs = (time.time() - t0) / len(ws)
        out, lo = [], 0
        for w, w2d in zip(ws, w2ds):
            hi = lo + w2d.shape[1]
            qt = make_qtensor(r.q[:, lo:hi], r.delta[lo:hi], r.z_lo[lo:hi],
                              w.shape, bits=spec0.bits)
            out.append((qt, _norm_of(e2_before[lo:hi]),
                        _norm_of(e2_after[lo:hi]), secs))
            lo = hi
        return out
    out = []
    for i, (w, w2d, spec) in enumerate(zip(ws, w2ds, specs)):
        t0 = time.time()
        # err_before, and the guards' reference error
        rt = rtn_quantize(w2d, spec, h=h)
        if guarding:
            r = guarded_solve(h, w2d, spec, method, block=block, gctx=gctx,
                              layer=layer, names=names[i:i + 1],
                              solve_fn=solve, presanitized=True,
                              ref_err=rt.errors[-1])
        else:
            r = solve(h, w2d, spec, method, block=block)
        qt = make_qtensor(r.q, r.delta, r.z_lo, w.shape, bits=spec.bits)
        out.append((qt, rt.errors[-1], r.errors[-1], time.time() - t0))
    return out


# ---------------------------------------------------------------------------
# stacked-expert leaves
# ---------------------------------------------------------------------------

def solve_experts(hs: Tensor, ws: Tensor, spec: QuantSpec,
                  method: str = "comq", block: int = 256) -> QuantResult:
    """`solve` for every expert of a stack: hs (E, m, m), ws (E, m, n).
    comq_blocked runs all experts in one batched solve; the other methods
    solve expert by expert. The result carries a leading E axis."""
    if method == "comq_blocked":
        return comq_quantize_blocked_experts(hs, ws, spec, block=block)
    rs = [solve(hs[e], ws[e], spec, method, block=block)
          for e in range(ws.shape[0])]
    return QuantResult(*(torch.stack([getattr(r, f) for r in rs])
                         for f in ("q", "delta", "z_lo", "z_hi", "errors")))


def _col_err2_experts(hs: Tensor, w: Tensor, wq: Tensor) -> Tensor:
    """(E, n) per-column squared reconstruction errors of an expert stack."""
    r = w - wq
    return torch.sum(r * torch.bmm(hs, r), dim=1)


def _expert_qtensor(q: Tensor, delta: Tensor, z_lo: Tensor, shape,
                    bits: int) -> dict:
    """An expert leaf's QTensor: codes (E, d, f), scale and zero-point
    (E, 1, f) (per layer (E, 1, 1)), broadcasting against the codes."""
    return make_qtensor(q, per_expert(delta.float()), per_expert(z_lo),
                        shape, bits=bits)


def _solve_group_experts(ws, hs: Tensor, specs, method: str, *,
                         gctx: Optional[GuardContext] = None,
                         layer: int = -1, names=None):
    """Stacked-expert leaves (E, d, f_k) sharing the per-expert Grams hs
    (E, d, d): every expert solved at once, column-fused across leaves
    when that is exact (identical specs and `_fusable`), else leaf by
    leaf.

    The guard policy is group-batched, as in the JAX package (whose solve
    is vmapped and cannot read the host per expert): non-finite Grams are
    zeroed up front, the unguarded solve runs, and only if the group's
    results are non-finite is the whole group retried under escalating
    damping (DAMP_MULTS), then quantized by RTN. A healthy group is the
    unguarded computation. Returns [(qtensor, err_before, err_after,
    seconds), ...]."""
    spec0 = specs[0]

    def one(hs_in, w, spec, meth):
        r = solve_experts(hs_in, w, spec, meth)
        rt = rtn_experts(w, spec)
        e2a = _col_err2_experts(hs_in, w,
                                r.q.float() * per_expert(r.delta))
        e2b = _col_err2_experts(hs_in, w,
                                rt.q.float() * per_expert(rt.delta))
        return r.q, r.delta, r.z_lo, e2a, e2b

    def run(hs_in, meth):
        if len(ws) > 1 and _uniform(specs) and _fusable(spec0, meth):
            t0 = time.time()
            wcat = torch.cat([w.float() for w in ws], dim=-1)
            q, delta, z_lo, e2a, e2b = one(hs_in, wcat, spec0, meth)
            secs = (time.time() - t0) / len(ws)
            out, lo = [], 0
            for w in ws:
                hi = lo + w.shape[-1]
                qt = _expert_qtensor(q[:, :, lo:hi], delta[:, lo:hi],
                                     z_lo[:, lo:hi], w.shape, spec0.bits)
                out.append((qt, _expert_norm_sum(e2b[:, lo:hi]),
                            _expert_norm_sum(e2a[:, lo:hi]), secs))
                lo = hi
            return out
        out = []
        for w, spec in zip(ws, specs):
            t0 = time.time()
            q, delta, z_lo, e2a, e2b = one(hs_in, w.float(), spec, meth)
            qt = _expert_qtensor(q, delta, z_lo, w.shape, spec.bits)
            out.append((qt, _expert_norm_sum(e2b), _expert_norm_sum(e2a),
                        time.time() - t0))
        return out

    if gctx is None or not gctx.enabled:
        return run(hs, method)
    if names is None:
        names = [f"leaf{i}" for i in range(len(ws))]
    n_bad = _guards.nonfinite_count(hs)
    if n_bad:
        hs = _guards.zero_nonfinite(hs)
        for nm in names:
            gctx.record(layer, nm, "nonfinite_gram", count=n_bad)
    out = run(hs, method)
    if _results_finite(out):
        return out
    for mult in _guards.DAMP_MULTS:
        out = run(_guards.damp_hessian(hs, mult), method)
        if _results_finite(out):
            for nm in names:
                gctx.record(layer, nm, "damping_escalated", mult=mult)
            return out
    out = run(hs, "rtn")
    for nm in names:
        gctx.record(layer, nm, "fallback", solver="rtn")
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


def _group_specs(resolve, layer_idx: int, entries, prefix: str = ""):
    """Resolved per-leaf specs for one tap group, in entry order."""
    return [resolve(layer_idx, f"{prefix}{mod}.{leaf}")
            for mod, leaf in entries]


def _sanitize_tap(gctx: GuardContext, tap: Tensor, layer: int,
                  names) -> Tensor:
    """Tap-collection NaN/Inf sentinel: zero (and record) non-finite
    activations before they reach the Gram."""
    if not gctx.enabled:
        return tap
    n_bad = _guards.nonfinite_count(tap)
    if n_bad:
        tap = _guards.zero_nonfinite(tap)
        for nm in names:
            gctx.record(layer, nm, "nonfinite_tap", count=n_bad)
    return tap


# ---------------------------------------------------------------------------
# crash-safe run context: journaling, resume, fault injection
# ---------------------------------------------------------------------------

def _spec_digest(spec: QuantSpec, method: str) -> int:
    """crc32 of the resolved spec + solver, part of the journal key: a
    journaled leaf is re-applied only under the spec a re-solve would get
    (the JAX package's digest)."""
    payload = {**asdict(spec), "method": method}
    return zlib.crc32(json.dumps(payload, sort_keys=True).encode())


def _run_digest(cfg, policy, method: str, propagation: str, tokens,
                quantize_unembed: bool, mesh=None) -> int:
    """crc32 over everything that must match for journaled leaves to equal
    a fresh solve: architecture, solver, policy, schedule, the whole
    calibration batch's token bytes, hashed as int32 (the JAX launcher's
    token type), and the mesh shape (another mesh sums the Grams in
    another order), so both packages give one digest for one run. `mesh`
    is a DeviceMesh, or anything with JAX's `shape` mapping."""
    tok = tokens.cpu().numpy().astype(np.int32)
    payload = {
        "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
        "method": method, "propagation": propagation,
        "policy": policy_to_dict(policy),
        "unembed": bool(quantize_unembed),
        "tokens": [zlib.crc32(tok.tobytes()), list(tok.shape),
                   str(tok.dtype)],
        "mesh": _mesh_term(mesh),
    }
    return zlib.crc32(json.dumps(payload, sort_keys=True).encode())


def _mesh_term(mesh):
    """The digest's mesh term: sorted [axis, size] pairs, or None."""
    if mesh is None:
        return None
    from repro_torch.dist.sharding import mesh_shape
    return sorted([k, v] for k, v in mesh_shape(mesh).items())


def _gram_fns(mesh):
    """(gram_fn, batched_fn) for (B, T, d) and (E, C, d) taps. With a mesh
    each takes this rank's rows and sums the Grams with one all-reduce
    over "data" (dist.reduce_gram / reduce_batched_gram)."""
    if mesh is None:
        return calibrate.gram_from_tap, calibrate.batched_gram
    from repro_torch import dist as _dist
    return (lambda tap: _dist.reduce_gram(mesh, tap),
            lambda tap: _dist.reduce_batched_gram(mesh, tap))


class _RunCtx:
    """Per-run plumbing threaded through the layer walk: the guard context
    (core/guards), the quantization journal (resume lookup + durable leaf
    commit), the fault injector, and the tracer and metrics registry (the
    null singletons when not given). Without journal and injector every
    hook is a no-op."""

    def __init__(self, method: str, gctx: GuardContext, device,
                 journal: Optional[QuantJournal] = None, solved=None,
                 injector=None, progress_cb=None, tracer=None,
                 metrics=None, journal_dir: Optional[str] = None,
                 mesh=None, solve_sh=None):
        self.method = method
        self.gctx = gctx
        self.device = device
        # the writer (rank 0's; None on the other ranks of a mesh, which
        # read journal_dir only)
        self.journal = journal
        self.journal_dir = journal.dir if journal is not None else journal_dir
        self.gram_fn, self.batched_fn = _gram_fns(mesh)
        self.solve_sh = solve_sh
        self.solved = dict(solved or {})   # (layer, name) -> leaf record
        self.injector = injector
        self.progress_cb = progress_cb
        self.resumed = 0
        self.tracer = tracer or NULL_TRACER
        self.metrics = metrics or NULL_METRICS
        self.m_layers = self.metrics.counter("quant.layers_done")
        self.m_leaves = self.metrics.counter("quant.leaves_solved")

    def fault(self, point: str, exc=InjectedFault) -> None:
        if self.injector is not None:
            self.injector.check(point, exc=exc)

    def poison_tap(self, tap: Tensor) -> Tensor:
        """nan_tap fault: poison one tap entry instead of raising."""
        if self.injector is not None and self.injector.fire("nan_tap"):
            tap = tap.clone()
            tap[(0,) * tap.dim()] = float("nan")
        return tap

    def lookup(self, layer: int, names, specs):
        """All-or-nothing journal hit for one tap group: every leaf must be
        journaled under its current spec digest, else the whole group
        re-solves (a partial hit would change the fused solve). Returns
        [(qtensor, leaf record), ...] or None."""
        if self.journal_dir is None or not self.solved:
            return None
        recs = []
        for nm, spec in zip(names, specs):
            rec = self.solved.get((layer, nm))
            if rec is None or rec["spec"] != _spec_digest(spec, self.method):
                return None
            recs.append(rec)
        loaded = []
        for rec in recs:
            qt_host = QuantJournal.load_leaf(self.journal_dir, rec)
            # intern the keys: a spill unpickles fresh string objects, and
            # pickle memoizes strings by object, so a later .qpk of the
            # resumed tree would differ in bytes from a fresh run's
            qt = {sys.intern(str(k)): (torch.tensor(v, device=self.device)
                                       if isinstance(v, np.ndarray) else v)
                  for k, v in qt_host.items()}
            loaded.append((qt, rec))
        self.resumed += len(loaded)
        return loaded

    def commit(self, layer: int, names, specs, results):
        """Durably persist each solved leaf — spill (atomic packed file)
        strictly before its journal record — and return the rows with
        host-float errors. Journaling pulls each group to the host once;
        without a journal the walk stays sync-free."""
        if self.journal is None:
            return results
        # comq: allow(host-sync) a journaled walk pulls each group once
        errs = torch.stack([torch.stack([torch.as_tensor(eb).float(),
                                         torch.as_tensor(ea).float()])
                            for _, eb, ea, *_ in results]).cpu().tolist()
        rows = []
        for nm, spec, (qt, _, _, secs, wall), (ebf, eaf) in zip(
                names, specs, results, errs):
            # comq: allow(host-sync) the spilled leaf, with its group's pull
            qt_host = {k: v.detach().cpu().numpy()
                       if isinstance(v, Tensor) else v for k, v in qt.items()}
            fname, crc = self.journal.spill_leaf(
                layer, nm, qt_host, fault_cb=self._ckpt_write_fault)
            self.journal.record_leaf(layer, nm,
                                     _spec_digest(spec, self.method),
                                     fname, crc, ebf, eaf)
            rows.append((qt, ebf, eaf, secs, wall))
        return rows

    def _ckpt_write_fault(self) -> None:
        self.fault("ckpt_write")

    def layer_done(self, layer: int) -> None:
        """End of a layer: journal the marker, report progress, and give
        the kill fault point its between-layers shot, after the layer's
        leaves are durably journaled."""
        if self.journal is not None:
            self.journal.record_layer_done(layer)
        self.m_layers.inc()
        if self.progress_cb is not None:
            self.progress_cb(layer)
        self.fault("kill", SimulatedKill)


def _timed_solve(ctx: _RunCtx, layer: int, tapname: str, names,
                 solve_thunk):
    """Run one tap group's solve under a `leaf_solve` span and extend each
    (qt, eb, ea, secs) row with its wall seconds. With a tracer the span
    waits for the solved codes before it closes (the current stream's
    synchronize on the card), so its duration, split evenly across the
    group, is the solve's wall time; without one the solve runs bare, the
    walk stays sync-free and the wall is 0.0 (unmeasured)."""
    if not ctx.tracer.enabled:
        results = solve_thunk()
        ctx.m_leaves.inc(len(results))
        return [r + (0.0,) for r in results]
    with ctx.tracer.span("leaf_solve", device=True, layer=layer,
                         tap=tapname, leaves=",".join(names)) as sp:
        results = solve_thunk()
        if ctx.device.type == "cuda":
            # comq: allow(host-sync) the traced span waits for its solve
            torch.cuda.current_stream(ctx.device).synchronize()
        wall = sp.elapsed_s / max(len(results), 1)
    ctx.m_leaves.inc(len(results))
    return [r + (wall,) for r in results]


def _quantize_tap_group(lp, tapname: str, entries, tap: Tensor, resolve,
                        method: str, layer_idx: int, ctx: _RunCtx,
                        pending: List[tuple], prefix: str = ""):
    """One tap group: re-apply its journaled leaves, or poison (nan_tap),
    sanitize the tap, take its Gram (per expert for a stacked-expert tap),
    solve the group and commit it. Leaf names carry `prefix` ("cross." in
    a VLM cross layer). Appends the report rows to `pending`; returns
    [(mod, leaf, qtensor), ...]."""
    names = [f"{prefix}{mod}.{leaf}" for mod, leaf in entries]
    specs = _group_specs(resolve, layer_idx, entries, prefix)
    cached = ctx.lookup(layer_idx, names, specs)
    if cached is not None:
        rows = [(qt, rec["err_before"], rec["err_after"], 0.0, 0.0)
                for qt, rec in cached]
    else:
        ctx.fault("gram_accumulate")
        tap = _sanitize_tap(ctx.gctx, ctx.poison_tap(tap), layer_idx, names)
        for _ in names:
            ctx.fault("leaf_solve")
        ws = [lp[mod][leaf] for mod, leaf in entries]
        if tapname.startswith("expert"):
            hs = ctx.batched_fn(tap)
            rows = _timed_solve(
                ctx, layer_idx, tapname, names,
                lambda: _solve_group_experts(ws, hs, specs, method,
                                             gctx=ctx.gctx, layer=layer_idx,
                                             names=names))
        else:
            h = ctx.gram_fn(tap)
            rows = _timed_solve(
                ctx, layer_idx, tapname, names,
                lambda: _solve_group(ws, h, specs, method,
                                     solve_sh=ctx.solve_sh, gctx=ctx.gctx,
                                     layer=layer_idx, names=names))
        rows = ctx.commit(layer_idx, names, specs, rows)
    out = []
    for (mod, leaf), nm, (qt, *errs_secs) in zip(entries, names, rows):
        pending.append((layer_idx, nm, *errs_secs))
        out.append((mod, leaf, qt))
    return out


def _staged_cb(lp, groups, taps, resolve, method: str,
               pending: List[tuple], layer_idx: int, holder: dict,
               ctx: _RunCtx, prefix: str = ""):
    """The staged `quantize_cb`: invoked by the model's tap hooks
    mid-forward, right after tap `tapname` is recorded. Quantizes the
    tap's leaf group (or re-applies it from the journal), stashes the
    QTensors in `holder`, and returns dequantized replacements so the rest
    of the forward runs on the quantized sub-blocks."""
    def cb(tapname: str):
        entries = groups.get(tapname)
        if not entries:
            return {}
        repl = {}
        for mod, leaf, qt in _quantize_tap_group(
                lp, tapname, entries, taps[tapname], resolve, method,
                layer_idx, ctx, pending, prefix):
            holder["lp_q"] = _set_nested(holder["lp_q"], mod, leaf, qt)
            repl[leaf] = dequant_qtensor(qt)
        return repl
    return cb


def _quantize_layer_staged(lp, x, state, cfg, plan, tapmap, resolve,
                           method: str, pending: List[tuple],
                           layer_idx: int, ctx: _RunCtx,
                           vision_kv=None, prefix: str = ""):
    """One `layer_full` evaluation quantizes the layer in tap order and
    propagates x (and the recurrent state) through the quantized
    sub-blocks; with `vision_kv` the layer is a VLM cross layer, its leaf
    names prefixed with `prefix`. Returns (lp_q, new_x, new_state)."""
    taps: Dict[str, Tensor] = {}
    holder = {"lp_q": lp}
    cb = _staged_cb(lp, _tap_groups(lp, tapmap), taps, resolve, method,
                    pending, layer_idx, holder, ctx, prefix)
    y, state = layer_with_state(lp, x, state, cfg, plan,
                                vision_kv=vision_kv, taps=taps,
                                quantize_cb=cb)
    return holder["lp_q"], y, state


def _quantize_layer_legacy(lp, x, state, cfg, plan, tapmap, resolve,
                           method: str, pending: List[tuple],
                           layer_idx: int, ctx: _RunCtx,
                           vision_kv=None, prefix: str = ""):
    """Legacy schedule: a float forward collects every tap of the layer,
    each tap group is solved from its Gram, and a second
    forward propagates x (and the recurrent state) through the quantized
    layer; `vision_kv` and `prefix` as in `_quantize_layer_staged`.
    Returns (lp_q, new_x, new_state)."""
    taps: Dict[str, Tensor] = {}
    layer_with_state(lp, x, state, cfg, plan, vision_kv=vision_kv,
                     taps=taps)
    lp_q = dict(lp)
    for tapname, entries in _tap_groups(lp, tapmap).items():
        for mod, leaf, qt in _quantize_tap_group(
                lp, tapname, entries, taps[tapname], resolve, method,
                layer_idx, ctx, pending, prefix):
            lp_q = _set_nested(lp_q, mod, leaf, qt)
    y, state = layer_with_state(dequantize_tree(lp_q), x, state, cfg, plan,
                                vision_kv=vision_kv)
    return lp_q, y, state


def _quantize_vlm(params, cfg, plan, x, vision_embeds, layer_fn, resolve,
                  method: str, pending: List[tuple], ctx: _RunCtx):
    """The VLM walk: group g's self layers (layer index g·(spg+1) + s,
    DENSE_TAPS), then its cross layer (index g·(spg+1) + spg, CROSS_TAPS)
    over the projected image's K/V. Returns the "__qlayers__" table, keyed
    "self_{g}_{s}" and "cross_{g}"."""
    from repro_torch.models.model import vlm_group_counts
    _, spg = vlm_group_counts(cfg)
    cd = x.dtype
    ve = torch.einsum("bnv,vd->bnd", vision_embeds.to(cd),
                      params["vision_proj"].to(cd))
    table = {}
    for gi, (gp_self, cp) in enumerate(zip(params["groups"]["self"],
                                           params["groups"]["cross"])):
        for si, lp in enumerate(gp_self):
            lidx = gi * (spg + 1) + si
            table[f"self_{gi}_{si}"], x, _ = layer_fn(
                lp, x, None, cfg, plan, DENSE_TAPS, resolve, method,
                pending, lidx, ctx)
            ctx.layer_done(lidx)
        vkv = tfm.vision_kv_for_layer(cp, ve)
        lidx = gi * (spg + 1) + spg
        table[f"cross_{gi}"], x, _ = layer_fn(
            cp, x, None, cfg, plan, CROSS_TAPS, resolve, method, pending,
            lidx, ctx, vision_kv=vkv, prefix="cross.")
        ctx.layer_done(lidx)
    return table


def _finalize_report(report: QuantReport, pending: List[tuple],
                     metrics=NULL_METRICS):
    """Move every per-leaf error scalar still on the device to the host in
    one transfer (a journaled run's are host floats already). Per-leaf
    metrics (final error, dispatch and wall seconds) are observed here,
    from the host values, never mid-walk."""
    on_dev = [v for row in pending for v in row[2:4]
              if isinstance(v, Tensor)]
    # comq: allow(host-sync) one transfer for the whole walk's errors
    host = iter(torch.stack([v.float() for v in on_dev]).cpu().tolist()
                if on_dev else ())
    h_err = metrics.histogram("quant.leaf_err_after")
    h_disp = metrics.histogram("quant.leaf_dispatch_seconds")
    h_wall = metrics.histogram("quant.leaf_wall_seconds")
    for li, name, eb, ea, secs, wall in pending:
        eb = next(host) if isinstance(eb, Tensor) else eb
        ea = next(host) if isinstance(ea, Tensor) else ea
        report.layers.append(LayerReport(li, name, float(eb), float(ea),
                                         secs, wall))
        h_err.observe(float(ea))
        h_disp.observe(secs)
        h_wall.observe(wall)
    return report


def _quantize_unembed(params, cfg, x: Tensor, resolve, method: str,
                      ctx: _RunCtx, pending: List[tuple]) -> dict:
    """The unembedding, solved on the final-norm activations (layer -1) or
    re-applied from the journal; returns its QTensor."""
    names, specs = ["unembed"], [resolve(-1, "unembed")]
    cached = ctx.lookup(-1, names, specs)
    if cached is not None:
        qt, rec = cached[0]
        row = (qt, rec["err_before"], rec["err_after"], 0.0, 0.0)
    else:
        ctx.fault("gram_accumulate")
        xn = _sanitize_tap(ctx.gctx, ctx.poison_tap(
            apply_norm(params["final_norm"], x, cfg)), -1, names)
        ctx.fault("leaf_solve")
        h = ctx.gram_fn(xn)
        rows = _timed_solve(
            ctx, -1, "unembed_in", names,
            lambda: _solve_group([params["unembed"]], h, specs, method,
                                 solve_sh=ctx.solve_sh, gctx=ctx.gctx,
                                 layer=-1, names=names))
        row = ctx.commit(-1, names, specs, rows)[0]
    qt, *errs_secs = row
    pending.append((-1, "unembed", *errs_secs))
    return qt


def _calib_leaf_dims(cfg) -> Dict[str, int]:
    """Leaf-class input dims for the calibration coverage check (an RWKV
    model: d_model alone, as in the JAX package)."""
    dims = {"d_model": cfg.d_model}
    if not cfg.attn_free:
        dims["wo_in"] = cfg.n_heads * cfg.resolved_head_dim
        dims["down_in"] = cfg.d_ff
    return dims


def quantize_model(params, cfg, plan, tokens: Tensor, spec,
                   method: str = "comq", quantize_unembed: bool = False,
                   propagation: str = "staged", *, guards: bool = True,
                   vision_embeds: Optional[Tensor] = None,
                   journal=None, resume: bool = False, injector=None,
                   progress_cb: Optional[Callable[[int], None]] = None,
                   tracer=None, metrics=None, mesh=None):
    """Quantize every projection weight of a dense, MoE, hybrid, RWKV or
    VLM LM (the router, the SSM's small leaves, RWKV's mixes, LoRAs and
    decay, and a cross layer's wk / wv and gates stay float). `tokens`:
    (B, T) calibration batch on the params' device; a VLM also needs
    `vision_embeds` (B, N, vision_dim), checked like the tokens.

    `spec` is a QuantSpec (every leaf gets it) or a `core.policy.
    QuantPolicy`, which resolves a spec per leaf (only the bit width
    varies). propagation="staged" (default) runs one forward per layer;
    "legacy" the two-forward schedule. quantize_unembed also solves the
    unembedding on the final-norm activations. guards=True runs the
    numeric guards (core/guards.py): a healthy run gives the same codes as
    guards=False, and every intervention lands in
    QuantReport.guard_events and the leaf's LayerReport.guard.

    Crash safety, all optional, as in the JAX package: `journal` (a
    directory or an ft.QuantJournal) spills and journals every solved
    leaf; resume=True re-applies the journaled leaves instead of solving
    them, giving the uninterrupted run's codes, scales and report rows bit
    for bit (QuantReport.resumed_leaves counts them); a journal written by
    another run (arch, policy, method, schedule or calibration tokens
    differ) raises ft.ResumeMismatch. `injector` (ft.FaultInjector) arms
    the pipeline's fault points; progress_cb(layer) runs after each
    durably journaled layer.

    Observability, as in the JAX package: `tracer` (obs.Tracer) records a
    `layer` span per layer (not in the VLM walk, as in JAX) and a
    `leaf_solve` span per solved tap group, which waits for the group's
    codes and fills LayerReport.wall_seconds; `metrics`
    (obs.MetricsRegistry) counts quant.layers_done, quant.leaves_solved,
    quant.resumed_leaves and quant.guard_events and observes the
    quant.leaf_err_after / leaf_dispatch_seconds / leaf_wall_seconds
    histograms. Neither changes a code, and without a tracer the walk adds
    no sync.

    Distribution, as in the JAX package: `mesh` (a DeviceMesh with axes
    ("data",) or ("data", "model"), every rank calling with the same
    arguments) shards the batch over "data" (one Gram all-reduce a tap;
    an MoE layer routes globally, its capacity aligned to the data axis)
    and, above one "model" rank, column-shards the per-channel
    comq_blocked / rtn solves. Every rank returns the whole result. The
    journal's digest holds the mesh shape; every rank reads the journal,
    rank 0 alone writes it, and with a registry the all-reduced Gram bytes
    are counted under `dist.bytes_all_reduced`.

    Returns (qparams, QuantReport): qparams is `params` plus a
    "__qlayers__" side table {str(layer): layer params with QTensor
    leaves} (a VLM's keys are "self_{g}_{s}" and "cross_{g}"; and a
    QTensor "unembed" with quantize_unembed, which a VLM ignores, as the
    JAX package does); use `materialize` (dense) or
    `core.apply.serving_params` (packed; not a VLM) to run it."""
    from repro_torch.data import (check_calib_coverage,
                                  validate_calib_features,
                                  validate_calib_tokens)
    from repro_torch.models.model import embed_tokens
    if propagation not in ("staged", "legacy"):
        raise ValueError(f"unknown propagation {propagation!r}")
    if cfg.family == "encoder":
        raise NotImplementedError(
            "quantize_model has no encoder walk: the JAX package's starts "
            "from embed_tokens (repro/core/pipeline.py), which an encoder "
            "does not have")
    policy = as_policy(spec)
    n_layers = cfg.n_layers

    def resolve(layer_idx: int, name: str) -> QuantSpec:
        return policy.resolve(name, layer_idx, n_layers)

    tapmap = taps_for(cfg)
    validate_calib_tokens(tokens, vocab_size=cfg.vocab_size)
    if cfg.family == "vlm":
        validate_calib_features(vision_embeds)
    check_calib_coverage(int(tokens.shape[0]) * int(tokens.shape[1]),
                         _calib_leaf_dims(cfg))
    layer_fn = (_quantize_layer_staged if propagation == "staged"
                else _quantize_layer_legacy)

    writer = True
    if mesh is not None:
        from repro_torch import dist as _dist
        writer = _dist.is_rank0()
    qj: Optional[QuantJournal] = None
    own_journal = False
    jdir: Optional[str] = None
    solved: Dict[Tuple[int, str], Dict] = {}
    if journal is not None:
        own_journal = not isinstance(journal, QuantJournal)
        jdir = journal if own_journal else journal.dir
        digest = _run_digest(cfg, policy, method, propagation, tokens,
                             quantize_unembed, mesh)
        if mesh is not None:
            _dist.world.barrier()      # an earlier attempt's writes are done
        st = QuantJournal.replay(jdir)
        if mesh is not None:
            _dist.world.barrier()      # every rank read before rank 0 writes
        if writer:
            qj = QuantJournal(journal) if own_journal else journal
        else:
            own_journal = False
        if resume and st.run is not None:
            if int(st.run["run"]) != digest:
                if own_journal:
                    qj.close()
                raise ResumeMismatch(
                    f"journal {jdir} was written by run digest "
                    f"{st.run['run']}, current run digest is {digest} "
                    "(arch/policy/method/calibration/mesh changed) — "
                    "refusing to mix journaled leaves into a different run")
            solved = dict(st.leaves)
            if qj is not None:
                qj.record_resume(len(solved))
        elif qj is not None:
            qj.record_run_start(digest, arch=cfg.name, method=method,
                                propagation=propagation,
                                n_layers=cfg.n_layers)

    solve_sh = None
    obs_prev, obs_set = None, False
    if mesh is not None:
        tokens = _dist.shard_batch(mesh, tokens)
        if vision_embeds is not None:
            vision_embeds = _dist.shard_batch(mesh, vision_embeds)
        ndata = _dist.axis_size(mesh, "data")
        if ndata > 1 and cfg.moe is not None:
            # global routing, with the capacity aligned so the (E, C, d)
            # expert taps divide the data axis
            plan = plan.replace(moe_capacity_multiple=ndata,
                                moe_group=_dist.axis_group(mesh, "data"))
        if (_dist.model_size(mesh) > 1
                and _col_shardable(policy.base, method)):
            def solve_sh(h, w2d, spec, block=256):
                return _dist.sharded_solve(mesh, h, w2d, spec, method,
                                           block=block)

    gctx = GuardContext(enabled=guards)
    ctx = _RunCtx(method, gctx, tokens.device, journal=qj, solved=solved,
                  injector=injector, progress_cb=progress_cb, tracer=tracer,
                  metrics=metrics, journal_dir=jdir, mesh=mesh,
                  solve_sh=solve_sh)
    if mesh is not None and ctx.metrics.enabled:
        # the Gram all-reduce bytes, from static shapes (no sync), for the
        # run's duration
        obs_prev = _dist.set_allreduce_observer(
            ctx.metrics.counter("dist.bytes_all_reduced").inc)
        obs_set = True
    t_start = time.time()
    report = QuantReport()
    pending: List[tuple] = []
    table = {}
    qparams = dict(params)
    try:
        with torch.no_grad():
            x = embed_tokens(params, cfg, plan, tokens)
            if cfg.family == "vlm":
                table = _quantize_vlm(params, cfg, plan, x, vision_embeds,
                                      layer_fn, resolve, method, pending,
                                      ctx)
                quantize_unembed = False
            state = None
            for l, lp in enumerate(params.get("layers", ())):
                with ctx.tracer.span("layer", layer=l, schedule=propagation):
                    lp_q, x, state = layer_fn(lp, x, state, cfg, plan,
                                              tapmap, resolve, method,
                                              pending, l, ctx)
                    table[str(l)] = lp_q
                ctx.layer_done(l)
            if quantize_unembed and "unembed" in params:
                qparams["unembed"] = _quantize_unembed(
                    params, cfg, x, resolve, method, ctx, pending)
        if qj is not None:
            qj.record_run_done()
    finally:
        if own_journal:
            qj.close()
        if obs_set:
            _dist.set_allreduce_observer(obs_prev)
    qparams["__qlayers__"] = table
    _finalize_report(report, pending, metrics=ctx.metrics)
    report.wall_seconds = time.time() - t_start
    report.guard_events = list(gctx.events)
    report.resumed_leaves = ctx.resumed
    ctx.metrics.counter("quant.guard_events").inc(len(report.guard_events))
    ctx.metrics.counter("quant.resumed_leaves").inc(ctx.resumed)
    gmap = gctx.by_leaf()
    for lr in report.layers:
        lr.guard = gmap.get((lr.layer, lr.name), "")
    return qparams, report


# ---------------------------------------------------------------------------
# materialize a runnable dequantized model
# ---------------------------------------------------------------------------

def materialize(qparams, cfg) -> Any:
    """Fold the __qlayers__ side table back into dense per-layer params (a
    VLM's into per-group lists). A stripped checkpoint
    (`ckpt.strip_for_serving`, no dense layers) rebuilds them from the
    table alone, which holds every per-layer leaf."""
    params = {k: v for k, v in qparams.items() if k != "__qlayers__"}
    table = qparams.get("__qlayers__", {})
    if not table:
        return params
    if cfg.family == "vlm":
        params["groups"] = _materialize_groups(table, params.get("groups"))
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


def _materialize_groups(table, dense):
    """The VLM table's "self_{g}_{s}" / "cross_{g}" entries as per-group
    lists of dense layers, in the dense groups' dtypes when given."""
    def deq(key, like):
        out = dequantize_tree(table[key])
        return out if like is None else _match_dtypes(out, like)

    n_groups = sum(k.startswith("cross_") for k in table)
    spg = sum(k.startswith("self_0_") for k in table)
    return {
        "self": [[deq(f"self_{g}_{s}",
                      dense and dense["self"][g][s]) for s in range(spg)]
                 for g in range(n_groups)],
        "cross": [deq(f"cross_{g}", dense and dense["cross"][g])
                  for g in range(n_groups)]}


def _match_dtypes(tree, like):
    if isinstance(tree, dict):
        return {k: _match_dtypes(v, like[k]) for k, v in tree.items()}
    return tree.to(like.dtype)
