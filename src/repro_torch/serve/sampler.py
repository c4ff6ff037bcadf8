"""Token samplers over logits (port of `repro.serve.sampler`).

`sample` keeps the engine's static-config API (Python-scalar temperature /
top_k / top_p); `sample_batch` is the continuous-batching form — per-slot
temperature/top_k/top_p arrive as (B,) arrays so one call serves a batch
of requests with heterogeneous settings; `sample_batch_seeded` makes each
row's draw a pure function of (seed, token index).

Random numbers come from explicit `torch.Generator`s. They are not
`jax.random`'s, so sampled streams match within the port only; greedy rows
are `argmax` exactly in every form."""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor
NEG = -1e30


def _nucleus_mask(scaled: Tensor, top_k: Tensor, top_p: Tensor) -> Tensor:
    """Mask (B, V) logits outside per-row top-k / top-p; top_k<=0 and
    top_p<=0 disable the respective filter. The most likely token always
    survives."""
    B, V = scaled.shape
    order = torch.argsort(-scaled, dim=-1, stable=True)     # descending
    sorted_l = torch.gather(scaled, -1, order)
    rank = torch.arange(V, device=scaled.device)[None]
    k_eff = torch.where(top_k > 0, top_k, V).long()[:, None]
    keep = rank < k_eff
    probs = torch.softmax(sorted_l, dim=-1)
    csum_excl = torch.cumsum(probs, dim=-1) - probs         # mass before
    p_eff = torch.where(top_p > 0, top_p, 1.0)[:, None]
    keep = keep & (csum_excl < p_eff)
    keep[:, 0] = True
    masked_sorted = torch.where(keep, sorted_l, NEG)
    inv = torch.argsort(order, dim=-1)
    return torch.gather(masked_sorted, -1, inv)


def _settings(logits: Tensor, temperature, top_k, top_p):
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev).reshape(-1)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).reshape(-1)
    top_p = torch.as_tensor(top_p, dtype=torch.float32,
                            device=dev).reshape(-1)
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    return temperature, _nucleus_mask(scaled, top_k, top_p)


def _draw(masked_row: Tensor, gen: torch.Generator) -> Tensor:
    probs = torch.softmax(masked_row, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[0]


def sample_batch(logits: Tensor, gen: torch.Generator, *, temperature,
                 top_k, top_p) -> Tensor:
    """logits: (B, V); temperature/top_p: (B,) f32; top_k: (B,) int.
    Per row: temperature<=0 -> greedy argmax; otherwise a top-k/top-p
    filtered categorical draw from `gen`. Returns (B,) int32."""
    temperature, masked = _settings(logits, temperature, top_k, top_p)
    probs = torch.softmax(masked, dim=-1)
    drawn = torch.multinomial(probs, 1, generator=gen)[:, 0]
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)


def _row_seed(seed: int, count: int) -> int:
    """Mix (request seed, token index) into one generator seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(count) + 1) % (1 << 64)
    x ^= x >> 31
    x = (x * 0xBF58476D1CE4E5B9) % (1 << 64)
    return (x ^ (x >> 29)) % (1 << 63)


def sample_batch_seeded(logits: Tensor, seeds, counts, *, temperature,
                        top_k, top_p) -> Tensor:
    """Replayable per-request sampling: logits (B, V); seeds (B,) per-
    request sampling seeds and counts (B,) index of the token being drawn,
    as host arrays. Row i draws from its own generator seeded from
    (seeds[i], counts[i]) — not from the slot index, the decode-step count
    or the other requests of the batch — so a preempted/resumed request
    redraws its exact stream. Greedy rows (temperature<=0) draw nothing
    and equal `argmax` bit for bit. Returns (B,) int32."""
    temps = (temperature.cpu().numpy() if isinstance(temperature, Tensor)
             else np.asarray(temperature, np.float32)).reshape(-1)
    _, masked = _settings(logits, temps, top_k, top_p)
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    seeds = np.asarray(seeds).reshape(-1)
    counts = np.asarray(counts).reshape(-1)
    for i in np.flatnonzero(temps > 0.0):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_row_seed(seeds[i], counts[i]))
        out[i] = _draw(masked[i], gen).to(torch.int32)
    return out


def sample(logits: Tensor, gen: torch.Generator, *,
           temperature: float = 0.0, top_k: int = 0,
           top_p: float = 0.0) -> Tensor:
    """logits: (B, V) -> (B,) int32. Static (Python-scalar) config form."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, NEG, logits)
    if top_p > 0.0:
        B = logits.shape[0]
        logits = _nucleus_mask(
            logits, torch.zeros(B, dtype=torch.int64, device=logits.device),
            torch.full((B,), top_p, dtype=torch.float32,
                       device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
