"""AdamW (f32 or int8 moments) and learning-rate schedules (port of
`repro.optim`)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "constant", "global_norm",
           "warmup_cosine"]
