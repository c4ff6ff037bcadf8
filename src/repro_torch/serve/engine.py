"""Static-slot batched engine: prefill + decode over equal-length prompts
(port of `repro.serve.engine`).

Kept as the equivalence baseline for the continuous-batching `Runtime`:
a dense per-slot `max_len` KV cache, one shared position, equal-length
prompts. Takes dense params or a packed QT-leaf tree
(`core.apply.serving_params`). Runs on the card unless `device="cpu"`.

Prefill and the decode step are JAX's two jitted programs: on the card
each is captured once as a CUDA graph per signature
(`analysis.retrace.guard_graph`) and replayed after; on the CPU each runs
eagerly through the same static buffers. Both share the engine's memory
pool (`retrace.GraphPool`): a prefill's logits and cache are read (the
cache copied into the engine's own, the first tokens sampled) before the
decode step replays.

The prefill's inputs are the tokens (B, T) and, for the VLM, the image
features; a signature is their shapes. The decode step is traced with
the position as a value: it is captured once per signature and replayed
for every position. The position is a device scalar the step itself
advances, the sampled tokens are copied into the graph's static input,
and the cache is the engine's own for the batch's shapes: the first
prefill of those shapes gives it (a signature's first call returns its
warm-up's tensors, which lie outside the graph pool), every later one is
copied into it, and the step writes the KV rows and the new recurrent
states (hymba's SSM, rwkv's) back into it in place, which is JAX's
donation. So the decode graph sees one cache for every prefill
signature. Sampling runs between replays, outside the graph.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.retrace import GraphPool, guard_graph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import decode_step, prefill
from repro_torch.serve.runtime import check_params_device
from repro_torch.serve.sampler import sample


def _tensors(tree):
    leaves, spec = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)], spec


def _prefill_batch(params, cfg, plan, tokens, vision_embeds=None):
    """JAX's jitted Engine prefill: (the last position's logits (B, V),
    the cache)."""
    return prefill(params, cfg, plan, tokens, vision_embeds=vision_embeds)


def _decode_into(params, cfg, plan, cache, tokens, pos):
    """One decode step that updates `cache` and `pos` in place: the KV rows
    are written in place already, the new recurrent states are copied into
    the cache's own, and the position advances. Returns the logits."""
    logits, new = decode_step(params, cfg, plan, cache, tokens, pos)
    (old, old_spec), (upd, new_spec) = _tensors(cache), _tensors(new)
    if old_spec != new_spec:
        raise ValueError(f"decode_step returned a cache of another "
                         f"structure: {new_spec} for {old_spec}")
    for dst, src in zip(old, upd):
        if dst is not src:
            dst.copy_(src)
    pos += 1
    return logits


class Engine:
    def __init__(self, params, cfg, plan, *, max_len: int = 512,
                 rng_seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.plan = plan.replace(prefill_cache_len=max_len)
        self.max_len = max_len
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # one prefill graph per signature (the tokens' and image
        # features' shapes) and one decode graph per signature (a batch's
        # cache shapes), each captured at its first call and replayed
        # after (the decode graph for every later position); one pool
        self._graph_pool = GraphPool()
        self._prefill = guard_graph(_prefill_batch,
                                    name="serve.engine.prefill",
                                    per_signature=True, copy_argnums=(3, 4),
                                    device=self.device, pool=self._graph_pool)
        self._decode = guard_graph(_decode_into,
                                   name="serve.engine.decode_step",
                                   per_signature=True, copy_argnums=(4,),
                                   device=self.device, pool=self._graph_pool)
        self._caches = {}    # cache shapes -> (static cache, position)

    def _static_cache(self, cache, pos: int):
        """The engine's cache and device position for `cache`'s shapes,
        holding `cache`'s rows and `pos`: the first prefill's own cache
        becomes it (new shapes mean a new prefill signature, whose first
        call returns its warm-up's tensors), a later one is copied in."""
        rows, spec = _tensors(cache)
        key = (str(spec), tuple((tuple(t.shape), t.dtype) for t in rows))
        held = self._caches.get(key)
        if held is None:
            held = self._caches[key] = (
                cache, torch.zeros((), dtype=torch.int64, device=self.device))
        else:
            for dst, src in zip(_tensors(held[0])[0], rows):
                dst.copy_(src)
        held[1].fill_(pos)
        return held

    def generate_batch(self, prompts: np.ndarray, *,
                       max_new_tokens: int = 32, temperature: float = 0.0,
                       vision_embeds=None) -> np.ndarray:
        """prompts: (B, T) int (equal length); a VLM also takes the image
        features `vision_embeds` (B, N, vision_dim), a tensor or an array.
        Returns (B, max_new_tokens) int32. Tokens stay on the device until
        the end."""
        B, T = prompts.shape
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        inputs = (tokens,)
        if vision_embeds is not None:
            inputs += (torch.as_tensor(vision_embeds, device=self.device),)
        logits, cache = self._prefill(self.params, self.cfg, self.plan,
                                      *inputs)
        cache, pos = self._static_cache(cache, T)
        out = torch.zeros(B, max_new_tokens, dtype=torch.int32,
                          device=self.device)
        for i in range(max_new_tokens):
            nxt = sample(logits, self.gen, temperature=temperature)
            out[:, i] = nxt
            if i + 1 < max_new_tokens:
                logits = self._decode(self.params, self.cfg, self.plan,
                                      cache, nxt[:, None].long(), pos)
        return out.cpu().numpy()  # comq: allow(host-sync) the result
