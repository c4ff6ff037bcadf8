"""Mixture-of-experts layer with static shapes (port of
`repro.models.moe`).

Routing is the JAX layer's: f32 router logits, top-k (ties to the lower
expert id, as `lax.top_k`), softmax over the k picked logits, and each
(token, slot) pair placed in its expert's capacity bucket by a cumulative
count in token-major, then slot order; pairs past the capacity are
dropped (contribute zero). The dispatch is an index scatter into the
(E, C, d) expert buffer and the combine a gather of each pair's expert
output, weighted and summed over the k slots in f32, instead of the JAX
layer's one-hot einsums: the same function, summed in another order. The
combine does not use `index_add_`, whose CUDA atomics add in no fixed
order. The expert GEMMs are batched products over the expert axis.

Padded experts (`BuildPlan.experts_padded`: E rounded up to a multiple
of the plan's tp, granite's 40 -> 48 at tp = 16) get -1e30 router logits
so no token routes there, as in the JAX layer; at tp = 1 none are
padded. The quantize walk and its launcher run at tp = 1, as JAX's do.

Global routing under a data axis (`group`, the "data" process group of
a sharded calibration walk): JAX routes the whole batch at once, with
the capacity of the global token count and bucket positions counted
over the global token-major order. Each rank holds a contiguous slice of
that order, so it all-gathers every rank's per-expert pair counts,
offsets its own positions by the lower ranks' counts and keeps a pair
when its global position is below the global capacity: JAX's kept set.
A rank's buckets hold its own kept rows at their global positions (the
others' rows are zero), so the all-reduced expert Gram is the replicated
one up to summation order, and every token's output is JAX's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.common import act_fn, dense_init, pad_to_multiple

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, cfg, n_experts_padded: int,
             device) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, n_experts_padded
    return {"router": dense_init(gen, (d, e), device, scale=0.02),
            "w_gate": dense_init(gen, (e, d, f), device),
            "w_up": dense_init(gen, (e, d, f), device),
            "w_down": dense_init(gen, (e, f, d), device)}


def _route(logits: Tensor, n_real: int, top_k: int):
    """logits (N, Ep) f32 -> (weights (N, k) f32, ids (N, k))."""
    e_pad = logits.shape[-1]
    if n_real < e_pad:
        logits = logits.clone()
        logits[..., n_real:] = -1e30
    # a stable descending sort breaks ties to the lower id, as lax.top_k
    w, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    w, ids = w[..., :top_k], ids[..., :top_k]
    return torch.softmax(w.float(), dim=-1), ids


def _one_hot(ids: Tensor, n: int) -> Tensor:
    """`F.one_hot(ids, n)` (int64) by a comparison: the same values, and
    nothing read on the host (on the CPU F.one_hot checks the ids' range
    with a host read)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def slots_for(ids: Tensor, e_pad: int, capacity: int,
              offset: Optional[Tensor] = None):
    """Capacity placement of routed pairs ids (N, k): (pos (N, k) the slot
    in the expert's bucket, by a cumulative count in token-major, then
    slot order, the first 0; slot (N, k) the row of the flat (E·C + 1)
    buffer: ids·C + pos, or E·C, the overflow row, for a dropped pair).
    `offset` (E,) counts the pairs routed to each expert before these
    tokens (on lower ranks, under global routing)."""
    N, k = ids.shape
    flat = ids.reshape(N * k)
    onehot = _one_hot(flat, e_pad)                    # (N·k, E)
    pos = torch.cumsum(onehot, dim=0).gather(1, flat[:, None])[:, 0] - 1
    if offset is not None:
        pos = pos + offset[flat]
    pos = pos.reshape(N, k)
    slot = torch.where(pos < capacity, ids * capacity + pos,
                       torch.full_like(pos, e_pad * capacity))
    return pos, slot


def route_slots(x: Tensor, router: Tensor, n_real: int, top_k: int,
                capacity: int, offset: Optional[Tensor] = None):
    """Router logits, routing and capacity placement of a token chunk
    x (N, d): (logits (N, E) f32, weights (N, k) f32, ids (N, k), pos,
    slot) with pos / slot as `slots_for` gives them."""
    logits = x.float() @ router.float()
    weights, ids = _route(logits, n_real, top_k)
    return (logits, weights, ids,
            *slots_for(ids, router.shape[-1], capacity, offset))


def lower_rank_counts(x: Tensor, router: Tensor, n_real: int, top_k: int,
                      chunk: int, n_chunks: int, group) -> Tensor:
    """Global routing's offsets: (n_chunks, E) pairs routed to each expert,
    per chunk of the global token order, by the ranks of `group` below
    this one. This rank's tokens x (N, d) are the global tokens
    [rank·N, (rank+1)·N); one all-gather of every rank's counts."""
    import torch.distributed as dist
    N = x.shape[0]
    e_pad = router.shape[-1]
    _, ids = _route(x.float() @ router.float(), n_real, top_k)
    me = dist.get_rank(group)
    chunk_of = (me * N + torch.arange(N, device=x.device)) // chunk
    counts = torch.zeros(n_chunks * e_pad, dtype=torch.int64,
                         device=x.device)
    counts.index_add_(0, (chunk_of[:, None] * e_pad + ids).reshape(-1),
                      torch.ones(ids.numel(), dtype=torch.int64,
                                 device=x.device))
    parts = [torch.empty_like(counts)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, counts, group=group)
    return torch.stack(parts[:me]).sum(dim=0).reshape(n_chunks, e_pad) \
        if me else counts.new_zeros(n_chunks, e_pad)


def _expert_ffn(w, xb: Tensor, cd) -> Tensor:
    """(E, C, a) · w (E, a, b) -> (E, C, b), batched over experts."""
    return torch.bmm(xb, w.to(cd))


def _dispatch_chunk(x: Tensor, p: dict, cfg, n_real: int, capacity: int,
                    taps=None, quantize_cb=None,
                    offset: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """x (N, d), one token chunk -> (y (N, d), aux loss scalar); `offset`
    as in `slots_for`."""
    cd = x.dtype
    N, d = x.shape
    e_pad = p["router"].shape[-1]
    k = cfg.moe.top_k
    logits, weights, ids, _, slot = route_slots(x, p["router"], n_real, k,
                                                capacity, offset)
    slot = slot.reshape(N * k)

    # dispatch: each kept (token, slot) pair's row into its bucket; the
    # overflow row E·C takes the dropped pairs and is cut off
    buf = torch.zeros(e_pad * capacity + 1, d, dtype=cd, device=x.device)
    buf[slot] = x.repeat_interleave(k, dim=0)
    xb = buf[:-1].reshape(e_pad, capacity, d)
    if taps is not None:
        taps["expert_in"] = xb          # (E, C, d): feeds w_gate / w_up
        if quantize_cb is not None:
            p = {**p, **quantize_cb("expert_in")}
    act = act_fn(cfg.act)
    if "w_gate" in p:
        h = act(_expert_ffn(p["w_gate"], xb, cd)) * _expert_ffn(
            p["w_up"], xb, cd)
    else:
        h = act(_expert_ffn(p["w_up"], xb, cd))
    if taps is not None:
        taps["expert_down_in"] = h      # (E, C, f): feeds w_down
        if quantize_cb is not None:
            p = {**p, **quantize_cb("expert_down_in")}
    yb = _expert_ffn(p["w_down"], h, cd)                 # (E, C, d)

    # combine: each pair's expert output (the zero row for a dropped
    # pair), weighted and summed over the k slots in f32
    rows = torch.cat([yb.reshape(e_pad * capacity, d),
                      yb.new_zeros(1, d)])[slot].reshape(N, k, d)
    wk = weights.to(cd).float()
    y = (wk[..., None] * rows.float()).sum(dim=1).to(cd)

    # load-balance aux loss (Switch-style), on the unmasked logits
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    ce = _one_hot(ids, e_pad).sum(dim=1).float().mean(dim=0)
    aux = e_pad * torch.sum(me * ce)
    return y, aux


def _capacity(n_tokens: int, cfg, multiple: int) -> int:
    moe = cfg.moe
    return pad_to_multiple(
        max(8, int(n_tokens * moe.top_k * moe.capacity_factor
                   / max(moe.n_experts, 1))), multiple)


def chunking(n_tokens: int, token_chunk: int) -> int:
    """The chunk the token axis is cut into: token_chunk, halved until it
    divides the token count."""
    chunk = min(token_chunk, n_tokens)
    while n_tokens % chunk:
        chunk //= 2
    return chunk


def apply_moe(p: dict, x: Tensor, cfg, n_experts_padded: int,
              token_chunk: int = 4096, taps=None, quantize_cb=None,
              capacity_multiple: int = 1, group=None) -> Tuple[Tensor, Tensor]:
    """x (B, T, d) -> (y, aux loss).

    With `taps` (calibration) one pass routes the whole batch under one
    capacity, records the router_in / expert_in / expert_down_in taps and
    makes the staged `quantize_cb` swaps. Otherwise the token axis runs in
    chunks of `token_chunk` (halved until it divides B·T), each with its
    own capacity, and the aux loss is their mean. `capacity_multiple`
    rounds the capacity up (only adds slots). With `group` x is this
    rank's contiguous slice of a batch sharded over the group's ranks, and
    routing is global (module docstring): capacities and chunks are the
    whole batch's, and the aux loss is this rank's chunks' mean."""
    B, T, d = x.shape
    n_real = cfg.moe.n_experts
    flat = x.reshape(B * T, d)
    N = flat.shape[0]
    ranks = 1
    if group is not None:
        import torch.distributed as dist
        ranks = dist.get_world_size(group)
    if taps is not None:
        taps["router_in"] = x
        offset = None
        if ranks > 1:
            offset = lower_rank_counts(flat, p["router"], n_real,
                                       cfg.moe.top_k, N * ranks, 1,
                                       group)[0]
        y, a = _dispatch_chunk(flat, p, cfg, n_real,
                               _capacity(N * ranks, cfg, capacity_multiple),
                               taps=taps, quantize_cb=quantize_cb,
                               offset=offset)
        return y.reshape(B, T, d), a
    chunk = chunking(N * ranks, token_chunk)
    capacity = _capacity(chunk, cfg, capacity_multiple)
    if ranks == 1:
        bounds = [(c * chunk, (c + 1) * chunk, c) for c in range(N // chunk)]
        offsets = None
    else:
        # the global chunks that meet this rank's tokens, cut to them
        me = dist.get_rank(group)
        n_chunks = N * ranks // chunk
        offsets = lower_rank_counts(flat, p["router"], n_real,
                                    cfg.moe.top_k, chunk, n_chunks, group)
        lo, hi = me * N, (me + 1) * N
        bounds = [(max(c * chunk, lo) - lo, min((c + 1) * chunk, hi) - lo, c)
                  for c in range(lo // chunk, (hi - 1) // chunk + 1)]
    ys, aux = [], torch.zeros((), device=x.device)
    for a0, a1, c in bounds:
        y, a = _dispatch_chunk(flat[a0:a1], p, cfg, n_real, capacity,
                               offset=None if offsets is None
                               else offsets[c])
        ys.append(y)
        aux = aux + a
    return torch.cat(ys).reshape(B, T, d), aux / len(bounds)
