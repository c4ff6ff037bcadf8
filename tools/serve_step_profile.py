#!/usr/bin/env python3
"""Where a full-width decode step's and prefill's time goes, eager and
replayed from their CUDA graphs, on one CUDA card.

    python3 tools/serve_step_profile.py

The step is chip_smoke.py phase 20's: qwen2-7b at full width cut to 2
layers (4-bit RTN codes here, from init_params(seed=0), where chip_smoke
serves phase 4's COMQ codes: the same shapes), 8 slots each holding 4000
tokens on 16-token pages, bf16 and int8 pages. For each: the step called
directly (`decode_step_paged`) and replayed from the Runtime's graph
(`Runtime._decode`, `analysis.retrace.guard_graph`), each the mean of 20
calls by CUDA events; torch.profiler's device time a step over 5 calls of
each (the sum of every kernel's time, and the largest kernels); the
step's bound (`roofline_terms` of its `count_cost`); the graph pool's
bytes; the card's name and power limit. Then the same readings for one
request's prefill at buckets 128 and 512 (bf16 pages, a prompt 5 tokens
short of the bucket): `_prefill_forward` called directly and the
bucket's graph (`Runtime._prefill_fn`, `serve.prefill[bucket]`)
replayed.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

ITERS, PROFILED = 20, 5
PREFILL_BUCKETS = (128, 512)


def device_ms(torch, fn, n):
    """(device ms a call, [(kernel, ms a call)] largest first) from
    torch.profiler over n calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    kernel = torch.autograd.DeviceType.CUDA     # kernels, not the ops
    rows = [(e.key, e.self_device_time_total / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == kernel and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import QuantSpec, quantize_model
    from repro_torch.core.apply import serving_params
    from repro_torch.launch.quantize import set_precision
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.models.model import decode_step_paged
    from repro_torch.roofline.analysis import H100, count_cost, \
        roofline_terms
    from repro_torch.roofline.kv_bytes import decode_step_inputs
    from repro_torch.serve import Runtime, ServeConfig
    from repro_torch.serve.runtime import _prefill_forward

    set_precision()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"device: {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen2-7b").replace(n_layers=2)
    with torch.no_grad():
        params = init_params(cfg, seed=0, device=dev)
        calib = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 32))).to(dev)
        qparams, _ = quantize_model(params, cfg, BuildPlan(), calib,
                                    QuantSpec(bits=4), method="rtn")
        sp = serving_params(qparams, cfg)
        del params, qparams
        sc = ServeConfig(max_slots=cs.ANALYSIS_SLOTS,
                         block_size=cs.ANALYSIS_BS,
                         num_blocks=cs.ANALYSIS_SLOTS * cs.ANALYSIS_MAXB,
                         buckets=(cs.PROMPT,),
                         max_blocks_per_slot=cs.ANALYSIS_MAXB)
        for kv_bits in (0, 8):
            rt = Runtime(sp, cfg, BuildPlan(kv_bits=kv_bits), sc,
                         device=dev)
            args = (rt.params, cfg, rt.plan, rt.pool,
                    *decode_step_inputs(rt, cs.ANALYSIS_LIVE))
            bound = roofline_terms(count_cost(decode_step_paged, *args),
                                   H100, kind="bf16")["bound_s"] * 1e3
            label = f"kv_bits={kv_bits}"
            for how, fn in (("eager", lambda i: decode_step_paged(*args)),
                            ("replayed", lambda i: rt._decode(*args))):
                ms = cs.cuda_ms(torch, fn, ITERS)
                dms, rows = device_ms(torch, fn, PROFILED)
                top = ", ".join(f"{k[:48]} {v:.4f}" for k, v in rows[:8])
                print(f"{label} {how}: {ms:.4f} ms a step (CUDA events, "
                      f"mean of {ITERS}); profiler device time {dms:.4f} ms "
                      f"a step (mean of {PROFILED}); bound {bound:.4f} ms "
                      f"({bound / ms:.3f} of the step); largest kernels "
                      f"(ms a step): {top}", flush=True)
            print(f"{label}: graph pool {rt.graph_pool_bytes()} bytes; "
                  f"{card}", flush=True)
            del rt, args
            torch.cuda.empty_cache()
        rt = Runtime(sp, cfg, BuildPlan(), sc, device=dev)
        for bucket in PREFILL_BUCKETS:
            n = bucket - 5
            tokens = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
            tokens[0, :n] = torch.arange(n, device=dev) * 7 % cfg.vocab_size
            tlen = torch.tensor(n, dtype=torch.int64, device=dev)
            plan = rt.plan.replace(prefill_cache_len=bucket)
            graph = rt._prefill_fn(bucket)
            for how, fn in (("eager", lambda i: _prefill_forward(
                    rt.params, cfg, plan, tokens, tlen)),
                            ("replayed", lambda i: graph(tokens, tlen))):
                ms = cs.cuda_ms(torch, fn, ITERS)
                dms, rows = device_ms(torch, fn, PROFILED)
                top = ", ".join(f"{k[:60]} {v:.4f}" for k, v in rows[:8])
                print(f"prefill[{bucket}] ({n} tokens) {how}: {ms:.4f} ms "
                      f"(CUDA events, mean of {ITERS}); profiler device time "
                      f"{dms:.4f} ms (mean of {PROFILED}); largest kernels "
                      f"(ms a call): {top}", flush=True)
        print(f"prefill: graph pool {rt.graph_pool_bytes()} bytes; {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
