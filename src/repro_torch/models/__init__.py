from repro_torch.models.model import (decode_step, decode_step_paged,
                                     embed_tokens, forward, init_cache,
                                     init_params, lm_loss, prefill, unembed)
from repro_torch.models.transformer import BuildPlan

__all__ = ["BuildPlan", "decode_step", "decode_step_paged", "embed_tokens",
           "forward", "init_cache", "init_params", "lm_loss", "prefill",
           "unembed"]
