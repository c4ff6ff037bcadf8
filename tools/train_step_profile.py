#!/usr/bin/env python3
"""Whether a full-width training step is host-paced or device-paced, on
one CUDA card: its wall time against the device time its kernels take.

    python3 tools/train_step_profile.py [case ...]

Cases (all by default): `qwen-f32` and `qwen-int8`, chip_smoke.py
phase 19(c)'s step (qwen2-7b at full width cut to 4 layers, 8 x 64
tokens, lr 3e-3, warmup 5, no remat, f32 or int8 AdamW moments), and
`granite`, one of 19(g)'s family steps (granite-moe-3b-a800m, 2 layers,
8 x 128, f32 moments). Each from `init_params(seed=0)` through
`make_train_step` (launch.train's step; eager), on SyntheticLM batches:
WARMUP steps, then the wall of each of TIMED steps (host clock, each
ending in a synchronize), then torch.profiler over PROFILED steps: the
device time a step (the sum of its kernels' times: one stream, so their
union) and the largest kernels. A device share near 1 means the step is
device-paced and a CUDA graph would gain little; far below 1, the card
waits on the host's dispatch. Prints the card's name and power limit.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

WARMUP, TIMED, PROFILED = 2, 5, 3
# case -> (arch, layers, batch, seq, moment dtype)
CASES = {"qwen-f32": ("qwen2-7b", 4, 8, 64, "float32"),
         "qwen-int8": ("qwen2-7b", 4, 8, 64, "int8"),
         "granite": ("granite-moe-3b-a800m", 2, 8, 128, "float32")}


def device_ms(torch, fn, n):
    """(device ms a call, host ms a call, [(kernel, ms a call)] largest
    first) from torch.profiler over n calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / n
    kernel = torch.autograd.DeviceType.CUDA     # kernels, not the ops
    rows = [(e.key, e.self_device_time_total / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == kernel and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), host, rows


def profile_case(torch, cs, name, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    arch, layers, B, T, moments = CASES[name]
    cfg = get_config(arch).replace(n_layers=layers)
    adamw = AdamWConfig(moment_dtype=moments)
    step = make_train_step(cfg, BuildPlan(remat=False),
                           RunConfig(arch=arch, learning_rate=cs.FIT_LR,
                                     warmup_steps=cs.FIT_WARMUP,
                                     total_steps=cs.FIT_STEPS), adamw)
    state = init_train_state(init_params(cfg, seed=0, device=dev), adamw)
    batches = [cs.family_batch(torch, cfg, B, T, dev, i)
               for i in range(WARMUP + TIMED + PROFILED)]
    box = {"state": state}

    def one(i):
        box["state"], m = step(box["state"], batches[i])
        return m
    for i in range(WARMUP):
        one(i)
    walls = []
    for i in range(WARMUP, WARMUP + TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = one(i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    dms, host, rows = device_ms(
        torch, lambda i: one(WARMUP + TIMED + i), PROFILED)
    top = ", ".join(f"{k[:40]} {v:.3f}" for k, v in rows[:8])
    print(f"{name} ({arch}, {layers} layers, {B}x{T}, {moments} moments): "
          f"step wall p50 {wall:.3f} ms over {TIMED} (host clock, "
          f"synchronized; walls {[round(w, 3) for w in walls]}), loss "
          f"{float(m['loss']):.4f}; profiler device time {dms:.3f} ms a "
          f"step over {PROFILED} ({host:.3f} ms wall a step under the "
          f"profiler): device share {dms / wall:.3f} of the wall; "
          f"largest kernels (ms a step): {top}; {card}", flush=True)
    del box, state, step, batches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    names = argv or list(CASES)
    unknown = [n for n in names if n not in CASES]
    if unknown:
        print(f"train_step_profile: unknown case(s) {unknown}; cases "
              f"{list(CASES)}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.launch.quantize import set_precision
    set_precision()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"device: {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda", 0)
    for name in names:
        profile_case(torch, cs, name, dev, card)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
