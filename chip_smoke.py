#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compile csrc/*.cu with nvcc, one process per source at once.
3. kernels — each Hopper kernel against its plain PyTorch version on the
   card at the main path's shapes, with times (CUDA events), the least time
   the card could take (bound) and a one-call PyTorch yardstick (library).
4. quantize — qwen2-7b at full width, n_layers cut 28 -> 2 (the only
   reduction): calibration 8x128, comq_blocked, 4-bit per-channel, greedy,
   3 sweeps, lambda 0.9; the launcher's JSON summary.
5. decode  — serving_params -> prefill of the 8x128 eval batch -> 16 greedy
   decode steps from the packed codes (bf16, the main path), held against
   the same steps run with the plain versions on the card (teacher-forced);
   then the same kernel-vs-plain comparison at f32 compute, which carries
   the precision gate (LOGITS_REL). Launch counts are reset before phase 4
   and read right after the main-path decode.
6. w_down  — one 18944x3584 w_down solve with the panel kernel against the
   same solve with the plain panel version.

Then one JSON line of the kernels, and last the device line.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}   # dense, no tensor-core f32

# tolerances (each kernel's source states the same)
PANEL_MIN_CODE_AGREEMENT = 0.999
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 8e-3, 1e-3
QMM_REL = 1e-3                      # max|Δ| <= QMM_REL * max|Y|
# decode logits, kernels vs plain versions, teacher-forced: max|Δ| <=
# REL * max|logits|. This random-init model amplifies rounding-level
# changes of projection outputs into much larger logit changes (PERF.md),
# so at bf16 every flipped rounding shows: the f32 run carries the
# precision gate and the bf16 main-path run a coarse one.
LOGITS_REL = {"bfloat16": 1e-1, "float32": 1e-2}
WDOWN_REL = 1e-3
LOSS_GAP = 0.15
PROMPT, STEPS = 128, 16


class CheckFailed(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def bound_ms(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn(i) over `iters` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_kernels(ops, modules):
    """Route the dispatch to the plain versions for a reference run on the
    card (only this script does this; the package never does)."""
    saved = {name: getattr(ops, name) for name in
             ("comq_panel_dq", "flash_attention", "quant_matmul")}
    panel, flash, qmm = modules
    ops.comq_panel_dq = panel.comq_panel_dq_plain
    ops.flash_attention = flash.flash_attention_plain
    ops.quant_matmul = qmm.quant_matmul_plain
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_panel(torch, panel, dev, results):
    gen = torch.Generator(device=dev).manual_seed(1)
    B = 256
    for n in (512, 3584, 18944):
        x = torch.randn(4 * B, B, generator=gen, device=dev)
        h_bb = (x.T @ x) / (4 * B) + 0.1 * torch.eye(B, device=dev)
        s0 = torch.randn(B, n, generator=gen, device=dev)
        qf = torch.randn(B, n, generator=gen, device=dev) * 3
        delta = torch.rand(n, generator=gen, device=dev) * 0.15 + 0.05
        z_lo = torch.full((n,), -8.0, device=dev)
        z_hi = torch.full((n,), 7.0, device=dev)
        hdiag = torch.diagonal(h_bb).contiguous()
        args = (h_bb, s0, qf, delta, z_lo, z_hi, hdiag)
        qk, dk = panel.comq_panel_dq_cuda(*args)
        qp, dp = panel.comq_panel_dq_plain(*args)
        torch.cuda.synchronize()
        agree = float((qk == qp).float().mean())
        err = float((qk - qp).abs().max())
        ms = cuda_ms(torch, lambda i: panel.comq_panel_dq_cuda(*args), 20)
        plain_ms = cuda_ms(torch, lambda i: panel.comq_panel_dq_plain(*args),
                           3)
        nbytes = 4 * (B * B + 2 * B * n + 3 * n + B) + 4 * 2 * B * n
        flops = 2.0 * n * B * (B - 1) / 2
        bms, by = bound_ms(nbytes, flops, "f32")
        say(f"kernel comq_panel B={B} n={n}: code agreement {agree:.6f} "
            f"(need >= {PANEL_MIN_CODE_AGREEMENT}), max|dq code| {err}, "
            f"ms {ms:.4f}, plain_ms {plain_ms:.3f}, bound_ms {bms:.4f} "
            f"({by}), library_ms null")
        check(agree >= PANEL_MIN_CODE_AGREEMENT,
              f"comq_panel n={n}: code agreement {agree}")
        results[("comq_panel", n)] = dict(ms=ms, plain_ms=plain_ms,
                                          bound_ms=bms, bound_by=by,
                                          library_ms=None, max_abs_err=err)


def check_flash(torch, flash, dev, results):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(2)
    B, T, H, KV, hd = 8, PROMPT, 28, 4, 128
    q = torch.randn(B, T, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, T, KV, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, T, KV, hd, generator=gen, device=dev).bfloat16()
    got = flash.flash_attention_cuda(q, k, v, causal=True).float()
    want = flash.flash_attention_plain(q, k, v, causal=True).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= FLASH_BF16_RTOL * want.abs() + FLASH_BF16_ATOL).all())
    ms = cuda_ms(torch, lambda i: flash.flash_attention_cuda(q, k, v), 50)
    plain_ms = cuda_ms(torch, lambda i: flash.flash_attention_plain(q, k, v),
                       10)
    library_ms = None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        library_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50)
    except TypeError:   # torch without enable_gqa: no one-call yardstick
        pass
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * hd * B * H * T * (T + 1) / 2
    bms, by = bound_ms(nbytes, flops, "bf16")
    say(f"kernel flash_attention B={B} T={T} H={H} KV={KV} hd={hd} bf16 "
        f"causal: max|d| {err:.3e} (tol {FLASH_BF16_RTOL}*|want|+"
        f"{FLASH_BF16_ATOL}), ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
        f"bound_ms {bms:.4f} ({by}), library_ms {library_ms}")
    check(ok, f"flash_attention disagrees with its plain version ({err})")
    results[("flash_attention",)] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bms, bound_by=by,
                                         library_ms=library_ms,
                                         max_abs_err=err)


def check_qmm(torch, qmm, dev, results):
    from repro_torch.core.quantizer import pack_codes, unpack_codes
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(M, K, N, 4) for M in (8, 1024)
             for K, N in ((3584, 18944), (18944, 3584), (3584, 512))]
    cases += [(8, 3584, 3584, 8), (8, 3584, 18944, 2)]
    for M, K, N, bits in cases:
        u = torch.randint(0, 2 ** bits, (K, N), generator=gen, device=dev,
                          dtype=torch.uint8)
        codes, cpb = pack_codes(u, bits)
        x = torch.randn(M, K, generator=gen, device=dev)
        scale = torch.rand(N, generator=gen, device=dev) * 0.04 + 0.01
        z = torch.randint(-(2 ** (bits - 1)), 0, (N,), generator=gen,
                          device=dev).float()
        got = qmm.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
        want = qmm.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        # rotate code copies past the 50 MB L2 so each launch streams codes
        # from HBM, as a decode step does
        n_copy = min(64, max(2, math.ceil(128e6 / codes.numel())))
        copies = [codes.clone() for _ in range(n_copy)]
        ms = cuda_ms(torch, lambda i: qmm.quant_matmul_cuda(
            x, copies[i % n_copy], scale, z, cpb=cpb), 20)
        plain_ms = cuda_ms(torch, lambda i: qmm.quant_matmul_plain(
            x, copies[i % n_copy], scale, z, cpb=cpb), 5)
        w = (unpack_codes(codes, cpb).float() + z) * scale
        library_ms = cuda_ms(torch, lambda i: torch.matmul(x, w), 10)
        del copies, w
        nbytes = 4 * M * K + codes.numel() + 8 * N + 4 * M * N
        bms, by = bound_ms(nbytes, 2.0 * M * K * N, "f32")
        say(f"kernel quant_matmul M={M} K={K} N={N} bits={bits} cpb={cpb}: "
            f"max|d|/max|y| {rel:.3e} (tol {QMM_REL}), ms {ms:.4f}, "
            f"plain_ms {plain_ms:.4f}, bound_ms {bms:.4f} ({by}), "
            f"library_ms {library_ms:.4f}")
        check(rel <= QMM_REL, f"quant_matmul {M}x{K}x{N} cpb={cpb}: {rel}")
        results[("quant_matmul", M, K, N, cpb)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=library_ms, max_abs_err=err)


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

def run_decode(torch, sp, cfg, plan, tokens, feed=None):
    """prefill + STEPS greedy decode steps; with `feed`, teacher-forced on
    those tokens. Returns (per-step logits, tokens fed)."""
    from repro_torch.models import decode_step, prefill
    logits, cache = prefill(sp, cfg, plan, tokens)
    outs, fed = [logits.float()], []
    for i in range(STEPS):
        tok = feed[i] if feed is not None else outs[-1].argmax(-1)
        fed.append(tok)
        logits, cache = decode_step(sp, cfg, plan, cache, tok[:, None],
                                    PROMPT + i)
        outs.append(logits.float())
    torch.cuda.synchronize()
    return outs, fed


def compare_decode(torch, ops, modules, sp, cfg, plan, tokens, outs, fed,
                   label):
    """Re-run the teacher-forced steps with the plain versions on the card
    and hold each step's logits against `outs`."""
    with torch.no_grad(), plain_kernels(ops, modules):
        ref_outs, _ = run_decode(torch, sp, cfg, plan, tokens, feed=fed)
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs, ref_outs)):
        d = (a - b).abs()
        rel = float(d.max()) / float(b.abs().max())
        worst = max(worst, rel)
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        say(f"decode {label} step {i}: max|d logits| {float(d.max()):.4e} "
            f"mean {float(d.mean()):.3e} (rel {rel:.3e}, tol "
            f"{LOGITS_REL[label]}), greedy token agreement {agree:.3f}")
    check(worst <= LOGITS_REL[label],
          f"decode logits ({label}) vs plain: rel {worst}")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          f"non-finite decode logits ({label})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch — run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import comq_quantize_blocked
    from repro_torch.core.apply import serving_params
    from repro_torch.core.calibrate import gram_from_tap
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import comq_panel as panel
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.launch.quantize import quantize_and_eval, set_precision
    from repro_torch.models import BuildPlan, embed_tokens
    from repro_torch.models.transformer import layer_full

    set_precision()
    dev = torch.device("cuda", 0)
    t_all = time.time()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    say(f"device: {smi.stdout.strip().splitlines()[0]}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    # 2. build
    t0 = time.time()
    secs = build.build()
    say(f"build: {time.time() - t0:.1f} s wall; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in build.SOURCES:
        for line in build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version
    results = {}
    check_panel(torch, panel, dev, results)
    check_flash(torch, flash, dev, results)
    check_qmm(torch, qmm, dev, results)

    # 4. quantize (main path, counted)
    cfg = get_config("qwen2-7b").replace(n_layers=2)
    say(f"reduced: n_layers 28 -> 2 (all widths full: d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})")
    ops.reset_launch_counts()
    t0 = time.time()
    run = quantize_and_eval(cfg, method="comq_blocked", calib_batch=8,
                            calib_seq=PROMPT, device=dev)
    s = run.summary
    say(f"quantize: {json.dumps(s)}")
    say(f"quantize: {time.time() - t0:.1f} s wall incl. init and eval; "
        f"launches so far {ops.launch_counts()}")
    imp = s["comq_vs_rtn_error_improvement"]
    check(math.isfinite(imp) and imp > 0,
          f"comq_vs_rtn_error_improvement {imp}")
    gap = abs(s["quant_loss"] - s["fp_loss"])
    check(gap <= LOSS_GAP, f"|quant_loss - fp_loss| = {gap} > {LOSS_GAP}")
    counts = ops.launch_counts()
    check(counts["comq_panel"] > 0 and counts["flash_attention"] > 0,
          f"quantize did not launch the kernels: {counts}")

    # 5. decode from the packed codes (main path, counted)
    sp = serving_params(run.qparams, cfg)
    plan = BuildPlan(prefill_cache_len=PROMPT + STEPS)
    t0 = time.time()
    with torch.no_grad():
        outs, fed = run_decode(torch, sp, cfg, plan, run.eval_tokens)
    say(f"decode: prefill 8x{PROMPT} + {STEPS} steps in "
        f"{time.time() - t0:.2f} s wall")
    counts = ops.launch_counts()
    say(f"main path launches: {counts}")
    check(all(v > 0 for v in counts.values()),
          f"a kernel of the main path never launched: {counts}")
    compare_decode(torch, ops, (panel, flash, qmm), sp, cfg, plan,
                   run.eval_tokens, outs, fed, "bfloat16")
    # the same steps at f32 compute with an f32 cache (outside the counted
    # main path)
    cfg32 = cfg.replace(compute_dtype="float32")
    plan32 = plan.replace(cache_dtype=torch.float32)
    with torch.no_grad():
        outs32, _ = run_decode(torch, sp, cfg32, plan32, run.eval_tokens,
                               feed=fed)
    compare_decode(torch, ops, (panel, flash, qmm), sp, cfg32, plan32,
                   run.eval_tokens, outs32, fed, "float32")
    del sp, outs, outs32

    # 6. one w_down leaf: panel kernel vs plain panel version
    with torch.no_grad():
        lp = run.params["layers"][0]
        taps = {}
        x = embed_tokens(run.params, cfg, BuildPlan(), run.calib_tokens)
        layer_full(lp, x, cfg, BuildPlan(), False, taps=taps)
        h = gram_from_tap(taps["down_in"])
        del taps, x
        w = lp["mlp"]["w_down"]
        spec = run.spec
        errs = {}
        for label, fn in (("kernel", None),
                          ("plain", panel.comq_panel_dq_plain)):
            torch.cuda.synchronize()
            t0 = time.time()
            r = comq_quantize_blocked(h, w, spec, panel_fn=fn)
            torch.cuda.synchronize()
            errs[label] = float(r.errors[-1])
            say(f"w_down {tuple(w.shape)} solve with {label} panel: error "
                f"trajectory {[round(float(e), 4) for e in r.errors]}, "
                f"{time.time() - t0:.2f} s wall")
        rel = abs(errs["kernel"] - errs["plain"]) / errs["plain"]
        say(f"w_down final error kernel vs plain: rel {rel:.3e} (tol "
            f"{WDOWN_REL})")
        check(rel <= WDOWN_REL, f"w_down final error differs by {rel}")

    # kernels line
    src = "src/repro_torch/csrc/{}.cu"
    entries = [
        ("comq_panel", results[("comq_panel", 18944)],
         "src/repro/kernels/comq_panel.py:79"),
        ("flash_attention", results[("flash_attention",)],
         "src/repro/kernels/flash_attention.py:95"),
        ("quant_matmul", results[("quant_matmul", 8, 3584, 18944, 2)],
         "src/repro/kernels/quant_matmul.py:94"),
    ]
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src.format(name),
         "replaces": where, "launches": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r, where in entries]}))
    say(f"chip_smoke: all phases passed in {time.time() - t_all:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
