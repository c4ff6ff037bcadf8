"""COMQ in Gram/Hessian space — the at-scale solvers (port of
`repro.core.comq_hessian`).

Every COMQ quantity is a function of H = XᵀX (m×m) and W only:

    ⟨x_i, s_ij⟩  = (H·R)_ij + (W_q)_ij · H_ii ,  R = W − W_q
    ‖x_i‖²       = H_ii
    greedy keys  ‖x_i‖·|w_ij| = √H_ii · |w_ij|

* `comq_quantize_h` — row-at-a-time, exact per-column greedy order.
* `comq_quantize_blocked` — panel solver with the trailing-update schedule:
  P = H·R is maintained across the whole solve, each solved B-row panel
  contributes one rank-B matmul `P -= H[:, blk] @ ΔW_blk`, and the
  strictly sequential intra-panel sweep is the `comq_panel` kernel
  (kernels/comq_panel.py). Shared order only. `schedule="refresh"` keeps
  the per-panel residual refresh for comparison.

The JAX package jits each multi-sweep solve; here the sweeps and panels are
Python loops over eager torch ops, and the maintained P / codes are updated
in place (one (m, n) buffer each instead of a fresh copy per panel).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.comq import QuantResult, make_orders
from repro_torch.core.quantizer import (EPS, QuantSpec, init_per_channel,
                                        init_per_layer, quantize_rtn)

Tensor = torch.Tensor


def gram(x: Tensor) -> Tensor:
    x = x.float()
    return x.T @ x


def _h_error(h: Tensor, w: Tensor, wq: Tensor) -> Tensor:
    """‖X(W − W_q)‖ from H: sqrt(tr(RᵀHR))."""
    r = w - wq
    val = torch.sum(r * (h @ r))
    return torch.sqrt(torch.clamp(val, min=0.0))


def _delta_update_h(h: Tensor, w: Tensor, qf: Tensor, per_layer: bool
                    ) -> Tensor:
    hq = h @ qf
    hw = h @ w
    if per_layer:
        num = torch.sum(qf * hw)
        den = torch.sum(qf * hq)
    else:
        num = torch.sum(qf * hw, dim=0)
        den = torch.sum(qf * hq, dim=0)
    return torch.where(den > EPS, num / den, torch.ones_like(den))


def _init_grid(w: Tensor, spec: QuantSpec):
    if spec.granularity == "per_layer":
        return init_per_layer(w, spec.bits)
    return init_per_channel(w, spec.bits, spec.lam)


def _safe_denom(denom: Tensor) -> Tensor:
    return torch.where(denom > 0, denom, torch.ones_like(denom))


# ---------------------------------------------------------------------------
# row-at-a-time H-space sweep (exact per-column greedy supported)
# ---------------------------------------------------------------------------

def _sweep_h(h: Tensor, p: Tensor, qf: Tensor, delta: Tensor, zlo: Tensor,
             zhi: Tensor, orders: Tensor, hdiag: Tensor):
    """p: (m, n) maintained product H·R with R = W − δ·Q. Updates p and qf
    in place."""
    m, n = qf.shape
    cols = torch.arange(n, device=qf.device)
    for t in range(m):
        idx = orders[t]
        qg = qf[idx, cols]
        hg = hdiag[idx]
        ratio = p[idx, cols] / _safe_denom(delta * hg)
        q_new = torch.clamp(torch.round(ratio + qg), zlo, zhi)
        q_new = torch.where(hg > EPS, q_new,
                            torch.clamp(torch.round(qg), zlo, zhi))
        du = (q_new - qg) * delta
        p -= h[:, idx] * du[None, :]
        qf[idx, cols] = q_new
    return p, qf


def comq_quantize_h(h: Tensor, w: Tensor, spec: QuantSpec) -> QuantResult:
    """H-space COMQ, `h` = XᵀX."""
    h = h.float()
    w = w.float()
    per_layer = spec.granularity == "per_layer"
    delta, z_lo, z_hi = _init_grid(w, spec)
    zlo, zhi = z_lo.float(), z_hi.float()
    hdiag = torch.diagonal(h)
    orders = make_orders(spec.order, torch.sqrt(hdiag), w)
    qf = w / delta
    errs = [_h_error(h, w, qf * delta)]
    for _ in range(spec.sweeps):
        p = h @ (w - qf * delta)
        p, qf = _sweep_h(h, p, qf, delta, zlo, zhi, orders, hdiag)
        delta = _delta_update_h(h, w, qf, per_layer)
        errs.append(_h_error(h, w, qf * delta))
    q = torch.clamp(torch.round(qf), zlo, zhi).to(torch.int32)
    return QuantResult(q=q, delta=delta, z_lo=z_lo, z_hi=z_hi,
                       errors=torch.stack(errs))


# ---------------------------------------------------------------------------
# blocked / panel solver (shared order only)
# ---------------------------------------------------------------------------

def shared_order(h: Tensor, w: Tensor, spec: QuantSpec) -> Tensor:
    """The (m,) shared visit order the blocked solver derives for (h, w)."""
    order_name = {"greedy": "greedy_shared"}.get(spec.order, spec.order)
    return make_orders(order_name, torch.sqrt(torch.diagonal(h)),
                       w.float())[:, 0]


def panel_sweep_dq_ref(h_bb: Tensor, s0: Tensor, qf_b: Tensor, delta,
                       z_lo, z_hi, hdiag_b: Tensor):
    """Intra-panel sweep emitting the scaled code delta — the plain version
    of the `comq_panel` kernel (kernels/comq_panel.py).

    h_bb: (B, B) block of H; s0: (B, n) = (H·R)[blk] before the panel;
    qf_b: (B, n) panel codes; delta/z_lo/z_hi: scalar or (n,). Returns
    (qf_b', ΔW) with ΔW = (qf_b' − qf_b)·δ.

    The sweep is lazy: each step's row is materialized as one matvec
    s_t = s0[t] − h_bb[t, :]·ΔW (rows ≥ t of ΔW are still 0)."""
    B = qf_b.shape[0]
    zlo = torch.as_tensor(z_lo, device=qf_b.device).float()
    zhi = torch.as_tensor(z_hi, device=qf_b.device).float()
    qf_b = qf_b.clone()
    du = torch.zeros_like(qf_b)
    for t in range(B):
        qg = qf_b[t]
        hg = hdiag_b[t]
        st = s0[t] - h_bb[t, :] @ du
        ratio = st / _safe_denom(delta * hg)
        q_new = torch.clamp(torch.round(ratio + qg), zlo, zhi)
        q_new = torch.where(hg > EPS, q_new,
                            torch.clamp(torch.round(qg), zlo, zhi))
        du[t] = (q_new - qg) * delta
        qf_b[t] = q_new
    return qf_b, du


def _blocked_core(hp: Tensor, wp: Tensor, hdiag: Tensor, delta, zlo, zhi, *,
                  spec: QuantSpec, m: int, block: int, panel_fn,
                  schedule: str):
    """Multi-sweep blocked solve over permuted/padded operands.

    trailing (default): P = H·R is maintained exactly across sweeps — each
    panel solve is followed by one rank-B update P -= H[:, blk] @ ΔW,
    applied in place with `addmm_`. Between sweeps H·Q is recovered
    elementwise from (HW − P)/δ, so the δ-update and the error trajectory
    cost no matmuls.

    refresh: every panel recomputes s0 = H[blk, :]·(W − δQ), and the
    δ-updates/errors each pay another (m, m)·(m, n) matmul per sweep."""
    per_layer = spec.granularity == "per_layer"
    m_pad, n = wp.shape
    B = block
    n_blocks = m_pad // B
    qf = wp / delta

    def panel(b, s0):
        sl = slice(b * B, (b + 1) * B)
        h_bb = hp[sl, sl].contiguous()
        qf_b, dq = panel_fn(h_bb, s0, qf[sl], delta, zlo, zhi, hdiag[sl])
        qf[sl] = qf_b
        return sl, dq

    if schedule == "trailing":
        hw = hp @ wp
        p = hp @ (wp - qf * delta)

        def h_err(p, qf, delta):
            # padded rows of H are zero, so P's padded rows vanish
            r = wp - qf * delta
            return torch.sqrt(torch.clamp(torch.sum(r * p), min=0.0))

        errs = [h_err(p, qf, delta)]
        for _ in range(spec.sweeps):
            for b in range(n_blocks):
                sl, dq = panel(b, p[b * B:(b + 1) * B].contiguous())
                p.addmm_(hp[:, sl], dq, alpha=-1.0)
            safe = torch.where(delta.abs() > EPS, delta,
                               torch.ones_like(delta))
            hq = (hw - p) / safe
            if per_layer:
                num = torch.sum(qf * hw)
                den = torch.sum(qf * hq)
            else:
                num = torch.sum(qf * hw, dim=0)
                den = torch.sum(qf * hq, dim=0)
            delta = torch.where(den > EPS, num / den, torch.ones_like(den))
            p = hw - delta * hq
            errs.append(h_err(p, qf, delta))
    elif schedule == "refresh":
        hm, wm = hp[:m, :m], wp[:m]
        errs = [_h_error(hm, wm, (qf * delta)[:m])]
        for _ in range(spec.sweeps):
            for b in range(n_blocks):
                r = wp - qf * delta
                panel(b, hp[b * B:(b + 1) * B] @ r)
            delta = _delta_update_h(hm, wm, qf[:m], per_layer)
            errs.append(_h_error(hm, wm, (qf * delta)[:m]))
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return qf, delta, torch.stack(errs)


def comq_quantize_blocked(h: Tensor, w: Tensor, spec: QuantSpec,
                          block: int = 256, panel_fn=None,
                          schedule: str = "trailing",
                          perm: Optional[Tensor] = None) -> QuantResult:
    """Blocked COMQ: cyclic or shared-greedy order.

    `panel_fn(h_bb, s0, qf_b, delta, z_lo, z_hi, hdiag_b) -> (qf_b', ΔW)`
    defaults to the `comq_panel` dispatch (kernels/ops.py): the Hopper
    kernel for CUDA tensors, its plain version for CPU tensors.
    `perm` optionally supplies the shared (m,) visit order."""
    h = h.float()
    w = w.float()
    m, n = w.shape
    delta, z_lo, z_hi = _init_grid(w, spec)
    if perm is None:
        perm = shared_order(h, w, spec)
    inv_perm = torch.argsort(perm)
    hp = h[perm[:, None], perm[None, :]]
    wp = w[perm]
    hdiag = torch.diagonal(hp).contiguous()
    if panel_fn is None:
        from repro_torch.kernels import ops
        panel_fn = ops.comq_panel_dq

    # pad rows to a multiple of the panel size (zero H rows: zero-diagonal
    # rows keep their code — no effect on real rows)
    B = min(block, m)
    m_pad = ((m + B - 1) // B) * B
    if m_pad != m:
        hp = F.pad(hp, (0, m_pad - m, 0, m_pad - m))
        wp = F.pad(wp, (0, 0, 0, m_pad - m))
        hdiag = F.pad(hdiag, (0, m_pad - m))

    zlo, zhi = z_lo.float(), z_hi.float()
    qf, delta, errs = _blocked_core(hp, wp, hdiag, delta, zlo, zhi,
                                    spec=spec, m=m, block=B,
                                    panel_fn=panel_fn, schedule=schedule)
    q = torch.clamp(torch.round(qf[:m]), zlo, zhi).to(torch.int32)
    return QuantResult(q=q[inv_perm], delta=delta, z_lo=z_lo, z_hi=z_hi,
                       errors=errs)


# ---------------------------------------------------------------------------
# blocked solver over a stack of experts
# ---------------------------------------------------------------------------

def per_expert(a: Tensor) -> Tensor:
    """A per-expert grid parameter, (E, n) or (E,), as (E, 1, n) or
    (E, 1, 1): broadcastable against (E, m, n)."""
    return a[:, None, :] if a.dim() == 2 else a[:, None, None]


def rtn_experts(w: Tensor, spec: QuantSpec) -> QuantResult:
    """Round-to-nearest of every expert of w (E, m, n) on its COMQ grid
    init (data-free; errors are not computed)."""
    w = w.float()
    delta, z_lo, z_hi = _init_grid(w, spec)
    q = quantize_rtn(w, per_expert(delta), per_expert(z_lo),
                     per_expert(z_hi))
    return QuantResult(q=q, delta=delta, z_lo=z_lo, z_hi=z_hi,
                       errors=torch.zeros(w.shape[0], 1, device=w.device))


def comq_quantize_blocked_experts(hs: Tensor, ws: Tensor, spec: QuantSpec,
                                  block: int = 256,
                                  panel_fn=None) -> QuantResult:
    """Blocked COMQ (trailing schedule) for E experts at once: hs (E, m, m)
    the per-expert Grams, ws (E, m, n) the weights.

    Each expert is the solve `comq_quantize_blocked` would run on
    (hs[e], ws[e]): its own shared visit order, its own δ grid and δ
    updates. The panel sweep is one `panel_fn` call for all experts, with
    operands batched along a leading E axis (the default is the
    `comq_panel` dispatch: one kernel launch per panel on the card), and
    each trailing update is one `baddbmm_`. Returns a QuantResult with a
    leading E axis: q (E, m, n), delta/z_lo/z_hi (E, n) (per layer (E,)),
    errors (E, sweeps+1)."""
    hs = hs.float()
    ws = ws.float()
    E, m, n = ws.shape
    per_layer = spec.granularity == "per_layer"
    delta, z_lo, z_hi = _init_grid(ws, spec)
    perm = torch.stack([shared_order(hs[e], ws[e], spec) for e in range(E)])
    inv_perm = torch.argsort(perm, dim=1)
    eidx = torch.arange(E, device=ws.device)[:, None]
    hp = hs[eidx[:, :, None], perm[:, :, None], perm[:, None, :]]
    wp = ws[eidx, perm]
    hdiag = torch.diagonal(hp, dim1=1, dim2=2).contiguous()
    if panel_fn is None:
        from repro_torch.kernels import ops
        panel_fn = ops.comq_panel_dq

    B = min(block, m)
    m_pad = ((m + B - 1) // B) * B
    if m_pad != m:
        hp = F.pad(hp, (0, m_pad - m, 0, m_pad - m))
        wp = F.pad(wp, (0, 0, 0, m_pad - m))
        hdiag = F.pad(hdiag, (0, m_pad - m))

    zlo, zhi = per_expert(z_lo).float(), per_expert(z_hi).float()
    # the panel's (E, n) column parameters
    zlo_v = zlo.expand(E, 1, n).reshape(E, n).contiguous()
    zhi_v = zhi.expand(E, 1, n).reshape(E, n).contiguous()
    db = per_expert(delta)
    qf = wp / db
    hw = torch.bmm(hp, wp)
    p = torch.bmm(hp, wp - qf * db)

    def h_err(p, qf, db):
        r = wp - qf * db
        return torch.sqrt(torch.clamp(torch.sum(r * p, dim=(1, 2)), min=0.0))

    errs = [h_err(p, qf, db)]
    for _ in range(spec.sweeps):
        d_v = db.expand(E, 1, n).reshape(E, n).contiguous()
        for b in range(m_pad // B):
            sl = slice(b * B, (b + 1) * B)
            qf_b, dq = panel_fn(hp[:, sl, sl].contiguous(),
                                p[:, sl].contiguous(),
                                qf[:, sl].contiguous(), d_v, zlo_v, zhi_v,
                                hdiag[:, sl].contiguous())
            qf[:, sl] = qf_b
            p.baddbmm_(hp[:, :, sl], dq, alpha=-1.0)
        safe = torch.where(db.abs() > EPS, db, torch.ones_like(db))
        hq = (hw - p) / safe
        dims = (1, 2) if per_layer else (1,)
        num = torch.sum(qf * hw, dim=dims, keepdim=True)
        den = torch.sum(qf * hq, dim=dims, keepdim=True)
        db = torch.where(den > EPS, num / den, torch.ones_like(den))
        p = hw - db * hq
        errs.append(h_err(p, qf, db))
    q = torch.clamp(torch.round(qf[:, :m]), zlo, zhi).to(torch.int32)
    delta = db[:, 0, 0] if per_layer else db[:, 0, :]
    return QuantResult(q=q[eidx, inv_perm], delta=delta, z_lo=z_lo,
                       z_hi=z_hi, errors=torch.stack(errs, dim=1))
