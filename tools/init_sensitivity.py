#!/usr/bin/env python3
"""Why the random-init encoder (vit-base-16) and VLM (llama-3.2-vision-90b)
amplify a rounding-sized change: their attention scores at init, and the
logit gap a change of the flash outputs makes, with the plain versions
only: the models, not a kernel.

    PYTHONPATH=src python3 tools/init_sensitivity.py [--model encoder vlm]
        [--eps 1e-7 1e-6 1e-3] [--device cuda] [--smoke]

`dense_init` draws a (d, heads, hd) projection with fan_in = shape[-2],
the head count, as the JAX package's does, so wq and wk come out
sqrt(d / heads) times wider than a fan-in-d init would draw them, and the
q.k scores grow by the product of the two factors. Each model runs twice:
with the init as it is ("as_is"), and with every wq / wk (self and cross
layers) multiplied by sqrt(shape[-2] / shape[0]), a fan-in-d init
("fan_in_d"). For each it prints JSON lines:

- "scores": for each flash call of one f32 forward, the std of the
  visible q.k / sqrt(hd) scores and the mean over query rows of the
  largest softmax probability (1.0: every row a hard argmax);
- "gap": for each (dtype, eps), the worst logit gap max|d| / max|logit|
  when every flash output is multiplied by (1 + eps * N(0, 1)). The
  encoder runs chip_smoke.py phase 15's forward (8 seeded images of 197
  patch embeddings); the VLM runs phase 14's decode (quantized at full
  width, 5 layers, materialized, both cross gates at 0.5; prefill 8x128
  with the images + 16 steps teacher-forced on the unperturbed run's
  tokens). eps 1e-7 to 1e-6 is the size of the f32 kernel's own difference
  from its plain version, 1e-3 below one bf16 ulp.

On a CUDA device every kernel is routed to its plain version, as
chip_smoke's reference runs are. `--smoke` runs the smoke configs (a CPU
rehearsal).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]


def fan_in_d(params):
    """`params` with every layer's wq / wk scaled to a fan-in-d init."""
    def fix(layer, mod):
        a = dict(layer[mod])
        for leaf in ("wq", "wk"):
            w = a[leaf]
            a[leaf] = w * math.sqrt(w.shape[-2] / w.shape[0])
        return {**layer, mod: a}
    if "groups" in params:
        g = params["groups"]
        return {**params, "groups": {
            "self": [[fix(lp, "attn") for lp in grp] for grp in g["self"]],
            "cross": [fix(cp, "xattn") for cp in g["cross"]]}}
    return {**params, "layers": [fix(lp, "attn") for lp in params["layers"]]}


@contextlib.contextmanager
def score_stats(torch, ops, stats: list):
    """Record the score statistics of each `ops.flash_attention` call."""
    from repro_torch.kernels.flash_attention import attention_mask
    real = ops.flash_attention

    def call(q, k, v, *, causal=True, window=0):
        B, Tq, H, hd = q.shape
        Tk, KV = k.shape[1], k.shape[2]
        qg = q.float().reshape(B, Tq, KV, H // KV, hd)
        s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) / math.sqrt(hd)
        mask = attention_mask(Tq, Tk, causal, window, q.device)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        stats.append({"Tq": Tq, "Tk": Tk, "causal": causal,
                      "score_std": float(s.masked_select(mask).std()),
                      "mean_max_prob": float(p.amax(-1).mean())})
        del s, p
        return real(q, k, v, causal=causal, window=window)
    ops.flash_attention = call
    try:
        yield
    finally:
        ops.flash_attention = real


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / float(
        b.float().abs().max())


def decode(torch, p, cfg, plan, tokens, ve, steps, feed=None):
    """prefill + `steps` greedy (or `feed`-forced) decode steps: per-step
    logits and the tokens fed."""
    from repro_torch.models import decode_step, prefill
    logits, cache = prefill(p, cfg, plan, tokens, vision_embeds=ve)
    outs, fed = [logits.float()], []
    for i in range(steps):
        tok = feed[i] if feed is not None else outs[-1].argmax(-1)
        fed.append(tok)
        logits, cache = decode_step(p, cfg, plan, cache, tok[:, None],
                                    tokens.shape[1] + i)
        outs.append(logits.float())
    return outs, fed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", nargs="+", default=["encoder", "vlm"],
                    choices=["encoder", "vlm"])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6,
                                                             1e-3])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from decode_sensitivity import perturbed
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import materialize
    from repro_torch.kernels import (comq_panel, flash_attention, ops,
                                     paged_attention, quant_matmul)
    from repro_torch.launch.quantize import quantize_and_eval
    from repro_torch.models import BuildPlan, forward, init_params, prefill

    dev = torch.device(args.device)
    get = get_smoke_config if args.smoke else get_config

    def plain():
        return (cs.plain_kernels(ops, (comq_panel, flash_attention,
                                       quant_matmul, paged_attention))
                if dev.type == "cuda" else contextlib.nullcontext())
    where = {"device": str(dev), "device_name": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}

    def emit(**kw):
        print(json.dumps({**kw, **where}), flush=True)

    for model in args.model:
        if model == "encoder":
            cfg = get(cs.ENC_ARCH)
            base = init_params(cfg, seed=0, device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn(8, cs.ENC_T, cfg.d_model, generator=gen,
                            device=dev)

            def run(p, c, x=x):
                return [forward(p, c, BuildPlan(), None, embeds=x)[0]]
        else:
            cfg = get(cs.VLM_ARCH).replace(n_layers=cs.VLM_LAYERS)
            q = quantize_and_eval(cfg, method="comq_blocked", calib_batch=8,
                                  calib_seq=cs.PROMPT, device=dev)
            base = cs.gated(torch, materialize(q.qparams, cfg), cs.VLM_GATE)
            ve, ev = q.vision_embeds, q.eval_tokens
            del q

            def run(p, c, feed=None, ve=ve, ev=ev):
                plan = BuildPlan(prefill_cache_len=cs.PROMPT + cs.STEPS,
                                 cache_dtype=getattr(torch, c.compute_dtype))
                return decode(torch, p, c, plan, ev, ve, cs.STEPS, feed)
        for variant, p in (("as_is", base), ("fan_in_d", fan_in_d(base))):
            stats = []
            c32 = cfg.replace(compute_dtype="float32")
            with torch.no_grad(), plain(), score_stats(torch, ops, stats):
                if model == "encoder":
                    run(p, c32)
                else:
                    prefill(p, c32, BuildPlan(), ev, vision_embeds=ve)
            emit(arch=cfg.name, layers=cfg.n_layers, init=variant,
                 what="scores", calls=stats)
            for dt in ("float32", "bfloat16"):
                c = cfg.replace(compute_dtype=dt)
                with torch.no_grad(), plain():
                    if model == "encoder":
                        want, feed = run(p, c), None
                    else:
                        want, feed = run(p, c)
                    for eps in args.eps:
                        with perturbed(torch, ops, ("flash_attention",), eps,
                                       dev):
                            got = (run(p, c) if model == "encoder"
                                   else run(p, c, feed)[0])
                        gaps = [rel(a, b) for a, b in zip(got, want)]
                        emit(arch=cfg.name, layers=cfg.n_layers, init=variant,
                             what="gap", dtype=dt, eps=eps,
                             run="forward" if model == "encoder" else
                             f"prefill + {cs.STEPS} decode steps",
                             worst_rel=max(gaps),
                             max_abs_logit=float(want[0].abs().max()))
        del base, p
    return 0


if __name__ == "__main__":
    sys.exit(main())
