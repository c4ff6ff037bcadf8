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

# the blocked solver's column tile (`_trailing`): it
# divides every column shard the column-sharded solve gives the configs'
# widths (3584, 512, 1024, 18944, 14336 over 2 or 4 model ranks)
COL_TILE = 128
# tiles a batched trailing update takes (`_trailing`)
TILE_BATCH = 8


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

    trailing (default, `_trailing`): P = H·R is maintained exactly across
    sweeps — each panel solve is followed by one rank-B update
    P -= H[:, blk] @ ΔW. Between sweeps H·Q is recovered elementwise from
    (HW − P)/δ, so the δ-update and the error trajectory cost no matmuls.

    refresh: every panel recomputes s0 = H[blk, :]·(W − δQ), and the
    δ-updates/errors each pay another (m, m)·(m, n) matmul per sweep."""
    if schedule == "trailing":
        return _trailing(hp, wp, hdiag, delta, zlo, zhi, spec=spec,
                         block=block, panel_fn=panel_fn)
    if schedule != "refresh":
        raise ValueError(f"unknown schedule {schedule!r}")
    per_layer = spec.granularity == "per_layer"
    B = block
    qf = wp / delta
    hm, wm = hp[:m, :m], wp[:m]
    errs = [_h_error(hm, wm, (qf * delta)[:m])]
    for _ in range(spec.sweeps):
        for b in range(wp.shape[0] // B):
            sl = slice(b * B, (b + 1) * B)
            r = wp - qf * delta
            qf[sl], _ = panel_fn(hp[sl, sl].contiguous(), hp[sl] @ r,
                                 qf[sl], delta, zlo, zhi, hdiag[sl])
        delta = _delta_update_h(hm, wm, qf[:m], per_layer)
        errs.append(_h_error(hm, wm, (qf * delta)[:m]))
    return qf, delta, torch.stack(errs)


def _trailing(hp: Tensor, wp: Tensor, hdiag: Tensor, delta, zlo, zhi, *,
              spec: QuantSpec, block: int, panel_fn):
    """The trailing schedule, with every product against H and every column
    sum over column tiles of one fixed width (COL_TILE).

    cuBLAS picks its f32 GEMM (tiling, split-K) by the whole product's
    shape, and `torch.sum(dim=0)` its reduction by the whole tensor's, so
    the same column of an (m, m)·(m, n) product would round otherwise at
    another n. Here W's columns are zero-padded to a multiple of the tile
    and held as (n_pad/tile, m_pad, tile) stacks. H·W and H·R are one
    (m_pad, m_pad)·(m_pad, tile) GEMM a tile, each column sum one
    reduction a tile, and each rank-B update P -= H[:, blk]·ΔW one batched
    GEMM (`baddbmm_`, H's columns broadcast) a TILE_BATCH tiles, the last
    batch filled with zero tiles: every call has one shape whatever n is,
    so cuBLAS runs one kernel for it. So a column's arithmetic depends
    only on its own tile, and a solve of
    any tile-aligned column range (a rank's share of the column-sharded
    solve, dist/calibrate.py) rounds each of its columns as the solve of
    the whole W does. On the CPU these are the codes of the JAX package's
    solve. Padded columns (w 0, δ 1, z 0) stay 0 and add nothing."""
    per_layer = spec.granularity == "per_layer"
    m_pad, n = wp.shape
    B, tile = block, COL_TILE
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    if pad:
        wp = F.pad(wp, (0, pad))
        if not per_layer:
            delta = F.pad(delta, (0, pad), value=1.0)
            zlo, zhi = F.pad(zlo, (0, pad)), F.pad(zhi, (0, pad))

    def tiles(x: Tensor) -> Tensor:       # (m_pad, n_pad) -> (T, m_pad, tile)
        return x.reshape(x.shape[0], n_tiles, tile).transpose(0, 1) \
            .contiguous()

    def col(v):                           # per column (n_pad,) -> (T, 1, tile)
        return v.reshape(n_tiles, 1, tile) if v.dim() else v

    def col_sum(x: Tensor) -> Tensor:     # (T, m_pad, tile) -> (n_pad,)
        return torch.cat([torch.sum(x[t], dim=0) for t in range(n_tiles)])

    def h_times(x: Tensor, out: Tensor) -> Tensor:   # H·x, a tile at a time
        for t in range(n_tiles):
            torch.mm(hp, x[t], out=out[t])
        return out

    # P and ΔW with zero tiles up to a whole number of TILE_BATCH batches
    n_batch = -(-n_tiles // TILE_BATCH) * TILE_BATCH
    p_all = wp.new_zeros(n_batch, m_pad, tile)
    dq_all = wp.new_zeros(n_batch, B, tile)
    wt = tiles(wp)
    qf = wp / delta
    hw = h_times(wt, torch.empty_like(wt))
    p = h_times(wt - tiles(qf) * col(delta), p_all[:n_tiles])

    def h_err(p, qf, delta):
        # padded rows of H are zero, so P's padded rows vanish
        r = wt - tiles(qf) * col(delta)
        return torch.sqrt(torch.clamp(torch.sum(col_sum(r * p)), min=0.0))

    errs = [h_err(p, qf, delta)]
    for _ in range(spec.sweeps):
        for b in range(m_pad // B):
            sl = slice(b * B, (b + 1) * B)
            s0 = p[:, sl].transpose(0, 1).reshape(B, -1)
            qf[sl], dq = panel_fn(hp[sl, sl].contiguous(), s0, qf[sl],
                                  delta, zlo, zhi, hdiag[sl])
            dq_all[:n_tiles] = dq.reshape(B, n_tiles, tile).transpose(0, 1)
            h_sl = hp[:, sl].expand(TILE_BATCH, m_pad, B)
            for g in range(0, n_batch, TILE_BATCH):
                p_all[g:g + TILE_BATCH].baddbmm_(
                    h_sl, dq_all[g:g + TILE_BATCH], alpha=-1.0)
        safe = torch.where(delta.abs() > EPS, delta, torch.ones_like(delta))
        hq = (hw - p) / col(safe)
        qt = tiles(qf)
        num = col_sum(qt * hw)
        den = col_sum(qt * hq)
        if per_layer:
            num, den = torch.sum(num), torch.sum(den)
        delta = torch.where(den > EPS, num / den, torch.ones_like(den))
        p.copy_(hw - col(delta) * hq)
        errs.append(h_err(p, qf, delta))
    if pad:
        qf = qf[:, :n]
        if not per_layer:
            delta = delta[:n]
    return qf, delta, torch.stack(errs)


def comq_quantize_blocked(h: Tensor, w: Tensor, spec: QuantSpec,
                          block: int = 256, panel_fn=None,
                          schedule: str = "trailing",
                          perm: Optional[Tensor] = None) -> QuantResult:
    """Blocked COMQ: cyclic or shared-greedy order.

    `panel_fn(h_bb, s0, qf_b, delta, z_lo, z_hi, hdiag_b) -> (qf_b', ΔW)`
    defaults to the `comq_panel` dispatch (kernels/ops.py): the Hopper
    kernel for CUDA tensors, its plain version for CPU tensors.
    `perm` optionally supplies the shared (m,) visit order. The trailing
    schedule runs over fixed column tiles (`_trailing`)."""
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
