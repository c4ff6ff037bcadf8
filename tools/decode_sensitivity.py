#!/usr/bin/env python3
"""How far a random-init model's decode amplifies a rounding-sized change,
with the plain versions only: the model, not a kernel.

    PYTHONPATH=src python3 tools/decode_sensitivity.py [--arch hymba-1.5b]
        [--layers 4] [--eps 1e-6 1e-7] [--device cuda] [--smoke]

Quantizes the arch at full width (random weights, seed 0) cut to
`--layers` layers, as chip_smoke.py does (comq_blocked, 4-bit, calibration
8x128), then runs chip_smoke's decode from the packed codes at f32 compute
with an f32 cache (prefill of the 8x128 eval batch, 16 greedy steps) with
every kernel routed to its plain version. It runs the same steps again,
teacher-forced on the first run's tokens, with the outputs of one kernel
dispatch multiplied by (1 + eps * N(0, 1)): `flash_attention` (the
prefill), `quant_matmul` (every decode projection), or both. eps of
1e-6 to 1e-7 is the size of the kernels' own difference from their plain
versions at f32 (chip_smoke phase 3: flash max|d| ~1.2e-6, quant_matmul
max|d|/max|y| ~7e-7). Prints one JSON line per (eps, site): each step's
logit gap max|d| / max|logit|, free-running, and the worst step: what
chip_smoke's free-running kernels-vs-plain comparison would show if the
kernels differed from the plain versions by that much and no more.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


@contextlib.contextmanager
def perturbed(torch, ops, names, eps, dev):
    """Multiply the outputs of the `ops` dispatches `names` by
    (1 + eps * N(0, 1)), from a fixed seed."""
    saved = {n: getattr(ops, n) for n in names}
    gen = torch.Generator(device=dev).manual_seed(123)

    def wrap(fn):
        def call(*a, **k):
            y = fn(*a, **k)
            noise = torch.randn(y.shape, generator=gen, device=dev)
            return (y.float() * (1 + eps * noise)).to(y.dtype)
        return call
    for n in names:
        setattr(ops, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-6, 1e-7])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (a CPU rehearsal)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.apply import serving_params
    from repro_torch.kernels import comq_panel, flash_attention, ops
    from repro_torch.kernels import paged_attention, quant_matmul
    from repro_torch.launch.quantize import quantize_and_eval
    from repro_torch.models import BuildPlan

    dev = torch.device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(n_layers=args.layers)
    kernels = (comq_panel, flash_attention, quant_matmul, paged_attention)
    run = quantize_and_eval(cfg, method="comq_blocked", calib_batch=8,
                            calib_seq=cs.PROMPT, device=dev)
    sp = serving_params(run.qparams, cfg)
    cfg32 = cfg.replace(compute_dtype="float32")
    plan32 = BuildPlan(prefill_cache_len=cs.PROMPT + cs.STEPS,
                       cache_dtype=torch.float32)

    sites = {"flash": ("flash_attention",), "qmm": ("quant_matmul",),
             "both": ("flash_attention", "quant_matmul")}
    with torch.no_grad(), cs.plain_kernels(ops, kernels):
        base, fed = cs.run_decode(torch, sp, cfg32, plan32, run.eval_tokens)
        for eps in args.eps:
            for site, names in sites.items():
                with perturbed(torch, ops, names, eps, dev):
                    outs, _ = cs.run_decode(torch, sp, cfg32, plan32,
                                            run.eval_tokens, feed=fed)
                rel = [float((a - b).abs().max()) / float(b.abs().max())
                       for a, b in zip(outs, base)]
                print(json.dumps({
                    "arch": cfg.name, "layers": args.layers,
                    "dtype": "float32", "device": str(dev),
                    "device_name": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
                    "eps": eps, "perturbed": site,
                    "worst_rel": max(rel),
                    "step_rel": [float(f"{r:.3e}") for r in rel]}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
