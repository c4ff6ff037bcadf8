"""Static-slot batched engine: prefill + decode over equal-length prompts
(port of `repro.serve.engine`).

Kept as the equivalence baseline for the continuous-batching `Runtime`:
a dense per-slot `max_len` KV cache, one shared position, equal-length
prompts. Takes dense params or a packed QT-leaf tree
(`core.apply.serving_params`). Runs on the card unless `device="cpu"`.

Prefill runs eagerly. The decode step is JAX's jitted one, traced with
the position as a value: on the card it is captured once as a CUDA graph
per signature (`analysis.retrace.guard_graph`) and replayed for every
position; on the CPU it runs eagerly through the same static buffers.
The position is a device scalar the step itself advances, the sampled
tokens are copied into the graph's static input, and the cache is the
engine's own for the batch's shapes: each prefill's rows are copied into
it, and the step writes the KV rows and the new recurrent states (hymba's
SSM, rwkv's) back into it in place, which is JAX's donation. Sampling
runs between replays, outside the graph.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.retrace import guard_graph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import decode_step, prefill
from repro_torch.serve.runtime import check_params_device
from repro_torch.serve.sampler import sample


def _tensors(tree):
    leaves, spec = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)], spec


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
        # one graph per signature (a batch's cache shapes), each captured
        # at its first step and replayed for every later position
        self._decode = guard_graph(_decode_into,
                                   name="serve.engine.decode_step",
                                   per_signature=True, copy_argnums=(4,),
                                   device=self.device)
        self._caches = {}    # cache shapes -> (static cache, position)

    def _static_cache(self, cache, pos: int):
        """The engine's cache and device position for `cache`'s shapes,
        holding `cache`'s rows and `pos`: the first prefill's own cache
        becomes it, a later one is copied in."""
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
        if vision_embeds is not None:
            vision_embeds = torch.as_tensor(vision_embeds,
                                            device=self.device)
        logits, cache = prefill(self.params, self.cfg, self.plan, tokens,
                                vision_embeds=vision_embeds)
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
