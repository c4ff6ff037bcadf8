"""Bytes-per-decode-token model for the paged serving runtime (port of
`repro.roofline.kv_bytes`).

The analytic companion of `roofline.analysis.count_cost`: where the count
measures what one eager decode step touches, this module predicts the
same per-step HBM traffic from first principles, with the JAX package's
two modes under their names and formulas:

* weights stream from HBM once per decode step (decode is weight-bound at
  batch ~slots: every matmul re-reads its weight panel);
* the paged pool's page codes and per-(layer, page, kv_head) scales are
  the only KV read traffic: dequantization folds into the attention, so
  quantized pages cut the KV term by 8/kv_bits against the bf16 pool;
* the decode append rewrites the touched page (the quantized insert
  rescales the page: one page read and one page write per layer and
  slot; the bf16 insert only writes the new row);
* "pallas" is the paged kernels' truth (in the port the hand-written
  `paged_attention[_quant]` kernels): only the pages a slot's length
  covers are read. "xla" counts what JAX's gather fallback materializes:
  every block-table slot, a compute-width copy, the insert scatter's full
  output and the layer scan's carried pool.

Activations are excluded: at decode (T=1) they are small beside the
weights, and the one materialized output (logits) is counted explicitly.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves


def pool_elem_bytes(plan) -> float:
    """Bytes per stored K/V element: code width under `plan.kv_bits`,
    cache dtype width otherwise."""
    kv_bits = int(getattr(plan, "kv_bits", 0) or 0)
    if kv_bits:
        return kv_bits / 8.0
    return float(torch.empty((), dtype=plan.cache_dtype).element_size())


def weight_stream_bytes(params) -> int:
    """Per-step weight traffic: every tensor leaf streams once, a packed
    `QT` leaf as its codes, scales and zero-points (JAX's QT pytree
    children)."""
    total = 0
    for x in tree_leaves(params):
        parts = ((x.codes, x.scale, x.z_lo) if hasattr(x, "codes")
                 else (x,))
        total += sum(t.numel() * t.element_size() for t in parts
                     if isinstance(t, torch.Tensor))
    return int(total)


def decode_kv_bytes(cfg, plan, *, max_slots: int, block_size: int,
                    max_blocks_per_slot: int, num_blocks: int = 0,
                    mode: str = "xla",
                    live_tokens: Optional[int] = None) -> Dict[str, float]:
    """Per-decode-step KV traffic (bytes), by term (JAX's formulas).

    "pallas": the paged kernels read only the live pages' codes + scales
    (bounded by `live_tokens`), and the append touches one page per slot.
    "xla": what the gather fallback materializes under the write-once
    model (`num_blocks` sizes the insert scatter's output; required)."""
    kv_bits = int(getattr(plan, "kv_bits", 0) or 0)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    B, BS, maxb = max_slots, block_size, max_blocks_per_slot
    eb = pool_elem_bytes(plan)
    if mode == "pallas":
        pages = maxb
        if live_tokens is not None:
            pages = min(maxb, max(1, math.ceil(live_tokens / BS)))
        codes = 2.0 * L * B * pages * BS * KV * hd * eb
        scales = 2.0 * L * B * pages * KV * 4.0 if kv_bits else 0.0
        if kv_bits:
            # the quantized append rescales the slot's tail page: page
            # read + page write + its scale row
            append = 2.0 * L * B * 2.0 * (BS * KV * hd * eb + KV * 4.0)
        else:
            append = 2.0 * L * B * KV * hd * eb   # one row per slot
        materialize = 0.0
    else:
        if not num_blocks:
            raise ValueError("xla mode needs num_blocks (scatter output)")
        codes = 2.0 * L * B * maxb * BS * KV * hd * eb
        scales = 2.0 * L * B * maxb * KV * 4.0 if kv_bits else 0.0
        cw = 4.0
        materialize = 2.0 * L * B * maxb * BS * KV * hd * cw
        append = 2.0 * L * num_blocks * BS * KV * hd * eb
        if kv_bits:
            append += 2.0 * L * num_blocks * KV * 4.0
    if mode == "xla":
        carry = 2.0 * L * num_blocks * BS * KV * hd * eb
        if kv_bits:
            carry += 2.0 * L * num_blocks * KV * 4.0
    else:
        carry = 0.0                                # updated in place
    total = codes + scales + append + materialize + carry
    return {"codes": codes, "scales": scales, "append": append,
            "materialize": materialize, "carry": carry, "kv_total": total}


def decode_step_bytes(params, cfg, plan, *, max_slots: int, block_size: int,
                      max_blocks_per_slot: int, num_blocks: int = 0,
                      mode: str = "xla",
                      live_tokens: Optional[int] = None) -> Dict[str, float]:
    """Predicted total HBM bytes for one decode step (all slots), plus the
    per-token figure the roofline quotes."""
    kv = decode_kv_bytes(cfg, plan, max_slots=max_slots,
                         block_size=block_size,
                         max_blocks_per_slot=max_blocks_per_slot,
                         num_blocks=num_blocks, mode=mode,
                         live_tokens=live_tokens)
    weights = float(weight_stream_bytes(params))
    logits = float(max_slots * cfg.vocab_size * 4)
    total = weights + kv["kv_total"] + logits
    out = dict(kv)
    out.update({"weights": weights, "logits": logits, "total": total,
                "per_token": total / max_slots})
    return out


def decode_step_inputs(rt, live_tokens: Optional[int] = None):
    """(block tables, tokens, positions) of a step in which every slot of
    `rt` (of its rank, under a mesh) holds `live_tokens` tokens (default:
    its whole table) on pages of its own."""
    B, BS, maxb = rt._spp, rt.serve_cfg.block_size, rt.maxb
    n = live_tokens or maxb * BS
    nb = int(rt.pool["k"].shape[1])
    bt = (np.arange(B * maxb).reshape(B, maxb) % nb).astype(np.int32)
    return (rt._upload(bt), rt._upload(np.zeros((B, 1), np.int64)),
            rt._upload(np.full((B,), n - 1, np.int32)))


def measured_decode_bytes(rt, live_tokens: Optional[int] = None) -> float:
    """Counted bytes of one decode step of a runtime's model
    (`count_cost`, the write-once model), every slot at `live_tokens`.
    Writes one row into each slot's pages: pass a fresh Runtime."""
    from repro_torch.models.model import decode_step_paged
    from repro_torch.roofline.analysis import count_cost
    with torch.no_grad():
        return float(count_cost(
            decode_step_paged, rt.params, rt.cfg, rt.plan, rt.pool,
            *decode_step_inputs(rt, live_tokens)).bytes_accessed)


def predicted_vs_measured_ratio(params, cfg, plan_bf16, plan_quant, *,
                                max_slots: int, block_size: int,
                                max_blocks_per_slot: int, num_blocks: int,
                                make_runtime,
                                live_tokens: Optional[int] = None
                                ) -> Dict[str, float]:
    """The gate: predicted ("pallas" mode: the port's decode step runs the
    paged kernels, which read the live pages only) vs counted
    bf16-over-quantized decode-step bytes ratio, every slot at
    `live_tokens`. `make_runtime(plan)` must return a fresh Runtime for
    the given plan."""
    kw = dict(max_slots=max_slots, block_size=block_size,
              max_blocks_per_slot=max_blocks_per_slot,
              num_blocks=num_blocks, mode="pallas", live_tokens=live_tokens)
    pred_b = decode_step_bytes(params, cfg, plan_bf16, **kw)["total"]
    pred_q = decode_step_bytes(params, cfg, plan_quant, **kw)["total"]
    meas_b = measured_decode_bytes(make_runtime(plan_bf16), live_tokens)
    meas_q = measured_decode_bytes(make_runtime(plan_quant), live_tokens)
    predicted = pred_b / pred_q
    measured = meas_b / meas_q
    return {"predicted": predicted, "measured": measured,
            "pred_bytes_bf16": pred_b, "pred_bytes_quant": pred_q,
            "meas_bytes_bf16": meas_b, "meas_bytes_quant": meas_q,
            "ratio_of_ratios": predicted / measured}
