#!/usr/bin/env python3
"""How far the random-init MoE model amplifies a rounding-sized change.

    PYTHONPATH=src python3 tools/moe_sensitivity.py [--layers 4]
        [--dtype bfloat16] [--eps 1e-3] [--device cpu]

Builds granite-moe-3b-a800m at full width (random weights, seed 0) cut to
`--layers` layers, runs one forward over a 2x64 random batch, then runs it
again with every attention output multiplied by (1 + eps * N(0, 1)), the
size of a rounding difference between two attention implementations
(eps ~4e-3 is a bf16 ulp), and prints one JSON line: the last position's
logit gap, max|Δ| / max|logit|, of the perturbed run free-running and in
lockstep (every layer started from the first run's hidden state and
routed as it was: chip_smoke.DecodeTape), and how many routed (token,
expert) pairs the free run changed. Plain versions only, so it needs no
card: it measures the model, not a kernel.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import BuildPlan, forward, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm

    dev = torch.device(args.device)
    cfg = get_config("granite-moe-3b-a800m").replace(
        n_layers=args.layers, compute_dtype=args.dtype)
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device=dev)
    real = ops.flash_attention

    def perturbed(q, k, v, **kw):
        o = real(q, k, v, **kw)
        g = torch.Generator(device=dev).manual_seed(123)
        noise = torch.randn(o.shape, generator=g, device=dev)
        return (o.float() * (1 + args.eps * noise)).to(o.dtype)

    def last_logits():
        return forward(params, cfg, BuildPlan(), tokens)[0][:, -1].float()

    tape = cs.DecodeTape(torch, tfm, moe_mod)
    with torch.no_grad():
        with tape.mode("record"):
            base = last_logits()
        ops.flash_attention = perturbed
        try:
            with tape.mode("free"):
                free = last_logits()
            with tape.mode("lockstep"):
                lock = last_logits()
        finally:
            ops.flash_attention = real
    top = float(base.abs().max())
    print(json.dumps({
        "arch": cfg.name, "layers": args.layers, "dtype": args.dtype,
        "eps": args.eps, "device": str(dev),
        "free_rel": float((free - base).abs().max()) / top,
        "lockstep_rel": float((lock - base).abs().max()) / top,
        "route_flips": tape.flips, "routed_pairs": tape.pairs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
