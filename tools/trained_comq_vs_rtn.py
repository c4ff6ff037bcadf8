#!/usr/bin/env python3
"""How far chip_smoke 19(e)'s readings move with the training run's
rounding, on one CUDA card: COMQ against RTN at 3 bits per channel on
the two models (e) quantizes, each retrained under equally valid
variants, through chip_smoke's own functions (`fit`, `learned_model`,
`comq_vs_rtn`).

    python3 tools/trained_comq_vs_rtn.py [variant ...]   # default: all

Variants, each a name `model:how`:
- model `c`: qwen2-7b at full width, 4 layers, trained as (c) (30 steps
  of 8 x 64 at lr 3e-3); model `learned`: (e)'s smoke model trained as
  JAX's tests/test_system.py (60 steps);
- how `kernels`: the backward kernels as the package plans them;
  `nsplit-N`: the bf16 dK/dV kernel with N query splits (at most the
  planner's cap), another f32 summation order of dK and dV; `plain`: the
  plain versions' autograd; `mb-N` (learned only): N microbatches a step,
  another summation order of the gradient.

Per variant it prints the training losses, the held-out losses (float,
COMQ, RTN), each quantized model's KL divergence from the float model,
and the verdict of each of (e)'s two readings: the eval loss (COMQ at
most RTN + 1e-4, JAX's test's gate; chip_smoke prints it) and the KL
(COMQ's at most RTN's; chip_smoke gates it on the learned model).
"""
from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

VARIANTS = (("c:kernels", "c:plain") + tuple(f"c:nsplit-{n}"
                                             for n in range(1, 7))
            + ("learned:kernels", "learned:plain", "learned:nsplit-1",
               "learned:mb-2", "learned:mb-4"))


@contextlib.contextmanager
def split_override(flash, nsplit):
    """plan_bwd's nsplit set to `nsplit`, capped as the planner caps it
    (the split it plans for a card without end)."""
    real = flash.plan_bwd

    def plan(B, Tq, Tk, H, KV, hd, sms):
        p = real(B, Tq, Tk, H, KV, hd, sms)
        n = min(real(B, Tq, Tk, H, KV, hd, 1 << 30).nsplit, nsplit)
        return flash.BwdPlan(n, p.blocks // p.nsplit * n)

    flash.plan_bwd = plan
    try:
        yield
    finally:
        flash.plan_bwd = real


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("trained_comq_vs_rtn: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import (build, comq_panel, flash_attention,
                                     ops, paged_attention, quant_matmul)
    from repro_torch.launch.quantize import set_precision

    set_precision()
    build.build()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels = (comq_panel, flash_attention, quant_matmul, paged_attention)
    work = Path(tempfile.mkdtemp(prefix="trained_comq_vs_rtn_"))
    for name in sys.argv[1:] or VARIANTS:
        model, how = name.split(":")
        ctx, extra = contextlib.nullcontext(), ()
        if how == "plain":
            ctx = cs.plain_kernels(ops, kernels)
        elif how.startswith("nsplit-"):
            ctx = split_override(flash_attention, int(how[7:]))
        elif how.startswith("mb-"):
            extra = ("--microbatches", how[3:])
        with ctx:
            if model == "c":
                cfg = get_config(cs.TRAIN_ARCH).replace(
                    n_layers=cs.TRAIN_LAYERS)
                with cs.SaveFilter(lambda step: False) as unsaved:
                    out, losses = cs.fit(torch, cfg,
                                         cs.fit_args(work / name, *extra),
                                         f"({name})", card,
                                         failure_hook=unsaved.hook)
                params = out["state"]["params"]
                del out
            else:
                cfg, params, losses = cs.learned_model(
                    torch, work / name, card, f"({name})", *extra)
        base, q, kl = cs.comq_vs_rtn(torch, params, cfg,
                                     *cs.held_out(torch, cfg, dev))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{name}: training losses first {losses[0]:.4f} last "
              f"{losses[-1]:.4f}; held-out float {base:.6f}, COMQ "
              f"{q['comq_blocked']:.6f}, RTN {q['rtn']:.6f} (COMQ - RTN "
              f"{q['comq_blocked'] - q['rtn']:+.4f}; <= 1e-4: "
              f"{q['comq_blocked'] <= q['rtn'] + 1e-4}); KL COMQ "
              f"{kl['comq_blocked']:.6g}, RTN {kl['rtn']:.6g} (ratio "
              f"{kl['comq_blocked'] / kl['rtn']:.4f}; <= 1: "
              f"{kl['comq_blocked'] <= kl['rtn']}) ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
