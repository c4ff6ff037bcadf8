#!/usr/bin/env python3
"""Whether a full-width step is host-paced or device-paced, on one CUDA
card: its wall time against the device time its kernels take.

    python3 tools/train_step_profile.py [case ...]

Cases (all by default): `qwen-f32` and `qwen-int8`, chip_smoke.py
phase 19(c)'s step (qwen2-7b at full width cut to 4 layers, 8 x 64
tokens, lr 3e-3, warmup 5, no remat, f32 or int8 AdamW moments), and
`granite`, one of 19(g)'s family steps (granite-moe-3b-a800m, 2 layers,
8 x 128, f32 moments). Each is the Trainer's step from
`init_params(seed=0)` on SyntheticLM batches (`chip_smoke.
train_step_timings`), called directly ("eager") and replayed from the
CUDA graph the Trainer captures ("replayed"), in turn on one state:
warm-up steps (the capture among them), the wall of each timed step
(host clock, each ending in a synchronize), then torch.profiler over a
few steps: the device time a step (the sum of its kernels' times: one
stream, so their union) and the largest kernels. A device share near 1
means the step is device-paced; far below 1, the card waits on the
host's dispatch.

`legacy`: the legacy quantize schedule's layer (`core/pipeline.
_quantize_layer_legacy`: a float forward that collects the taps, the
tap groups' solves, a second forward through the quantized layer) at
qwen2-7b full width, 2 layers, calibration 8 x 128, comq_blocked 4-bit:
each layer's wall and its two forwards' walls inside the walk
(synchronized around each; the kernels are built before the first case,
so no layer's wall holds a build), then each forward of layer 0 run
again alone on the same inputs, its wall against its profiler device
time.
Prints the card's name and power limit.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# case -> (arch, layers, batch, seq, moment dtype)
CASES = {"qwen-f32": ("qwen2-7b", 4, 8, 64, "float32"),
         "qwen-int8": ("qwen2-7b", 4, 8, 64, "int8"),
         "granite": ("granite-moe-3b-a800m", 2, 8, 128, "float32")}
LEGACY = ("qwen2-7b", 2, 8, 128)      # arch, layers, calib batch, calib seq
LEGACY_REPEATS = 3


def profile_case(torch, cs, name, dev, card):
    from repro_torch.configs import get_config
    arch, layers, B, T, moments = CASES[name]
    cfg = get_config(arch).replace(n_layers=layers)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        cs.train_step_timings(
            torch, cfg, moments, B, T, dev, Path(work),
            f"{name} ({arch}, {layers} layers, {B}x{T}, {moments} moments)",
            card)


def legacy_case(torch, cs, dev, card):
    """The legacy schedule's layer: walls inside the walk, then layer 0's
    two forwards alone, wall against profiler device time."""
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline
    from repro_torch.launch.quantize import quantize_and_eval
    arch, layers, B, T = LEGACY
    cfg = get_config(arch).replace(n_layers=layers)
    real_layer, real_fwd = (pipeline._quantize_layer_legacy,
                            pipeline.layer_with_state)
    rec = {"layer": [], "forward": [], "calls": []}

    def synced(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t0) * 1e3)
            if key == "forward" and len(rec["calls"]) < 2:
                rec["calls"].append((a, {k_: v for k_, v in k.items()
                                         if k_ != "taps"}, "taps" in k))
            return out
        return run

    pipeline._quantize_layer_legacy = synced(real_layer, "layer")
    pipeline.layer_with_state = synced(real_fwd, "forward")
    try:
        t0 = time.perf_counter()
        run = quantize_and_eval(cfg, method="comq_blocked", calib_batch=B,
                                calib_seq=T, propagation="legacy",
                                device=dev)
        torch.cuda.synchronize()
        walk = time.perf_counter() - t0
    finally:
        pipeline._quantize_layer_legacy = real_layer
        pipeline.layer_with_state = real_fwd
    fwd = rec["forward"][:2 * layers]
    shares = [round((a + b) / w, 4)
              for a, b, w in zip(fwd[::2], fwd[1::2], rec["layer"])]
    print(f"legacy ({arch}, {layers} layers at full width, calibration "
          f"{B}x{T}, comq_blocked 4-bit): quantize_and_eval {walk:.3f} s "
          f"wall (init and eval included); layer walls (ms, synchronized) "
          f"{[round(w, 3) for w in rec['layer']]}; inside them the float "
          f"tap forward and the second forward (ms) "
          f"{[round(w, 3) for w in fwd]}: forwards {shares} of each "
          f"layer's wall; summary "
          f"improvement {run.summary['comq_vs_rtn_error_improvement']:.4f}; "
          f"{card}", flush=True)
    for (args, kw, tapped), what in zip(rec["calls"],
                                        ("float tap forward",
                                         "second forward")):
        def call(i, args=args, kw=kw, tapped=tapped):
            return real_fwd(*args, **kw, **({"taps": {}} if tapped else {}))
        with torch.no_grad():
            call(0)
            walls = []
            for i in range(LEGACY_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(i)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            dms, host, rows = cs.profiled_ms(torch, call, LEGACY_REPEATS)
        wall = statistics.median(walls)
        top = ", ".join(f"{k[:40]} {v:.3f}" for k, v in rows[:6])
        print(f"legacy layer 0 {what} alone: wall p50 {wall:.3f} ms over "
              f"{LEGACY_REPEATS} (walls {[round(w, 3) for w in walls]}); "
              f"profiler device time {dms:.3f} ms ({host:.3f} ms wall a call "
              f"under the profiler): device share {dms / wall:.3f}; largest "
              f"kernels (ms a call): {top}; {card}", flush=True)
    del run, rec


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    names = argv or [*CASES, "legacy"]
    unknown = [n for n in names if n not in CASES and n != "legacy"]
    if unknown:
        print(f"train_step_profile: unknown case(s) {unknown}; cases "
              f"{[*CASES, 'legacy']}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch.quantize import set_precision
    set_precision()
    build.build()           # every kernel, before any wall is read
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"device: {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    for name in names:
        if name == "legacy":
            legacy_case(torch, cs, dev, card)
        else:
            profile_case(torch, cs, name, dev, card)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
