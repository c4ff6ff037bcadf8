"""Static-slot batched engine: prefill + decode over equal-length prompts
(port of `repro.serve.engine`).

Kept as the equivalence baseline for the continuous-batching `Runtime`:
a dense per-slot `max_len` KV cache, one shared position, equal-length
prompts. Takes dense params or a packed QT-leaf tree
(`core.apply.serving_params`). Runs on the card unless `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import decode_step, prefill
from repro_torch.serve.runtime import check_params_device
from repro_torch.serve.sampler import sample


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
        out = torch.zeros(B, max_new_tokens, dtype=torch.int32,
                          device=self.device)
        for i in range(max_new_tokens):
            nxt = sample(logits, self.gen, temperature=temperature)
            out[:, i] = nxt
            if i + 1 < max_new_tokens:
                logits, cache = decode_step(self.params, self.cfg, self.plan,
                                            cache, nxt[:, None].long(),
                                            T + i)
        return out.cpu().numpy()  # comq: allow(host-sync) the result
