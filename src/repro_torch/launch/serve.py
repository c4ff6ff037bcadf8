"""Serving launcher (port of `repro.launch.serve`): continuous-batching
generation from an optionally COMQ-quantized, optionally packed-on-disk
checkpoint, or from a fresh init.

    # quantize, save the packed checkpoint, serve packed (no materialize)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --smoke --quantize --bits 4 --save-quantized /tmp/q.qpk \
        --num-requests 4 --max-new 16 --mixed --stagger 2 --device cpu

    # later runs start from the packed checkpoint (written by either
    # package's serve launcher)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --smoke --load-quantized /tmp/q.qpk --num-requests 4 --max-new 16

`--engine paged` (default) drives serve.Runtime — paged KV pool, priority
admission with preemption-by-page-reclaim (`--admission reserve` keeps
full-lifetime reservation), mixed prompt lengths, staggered arrivals,
bf16 or int8/4-bit pages (`--kv-bits`). `--engine static` runs the
equal-length Engine baseline; a parallel-SSM arch (hymba-1.5b), an
attention-free one (rwkv6-7b) and a VLM always run it (`--engine paged`
switches with a note, as the JAX launcher does). A VLM then exits 1: the
launcher has no source of image features (the JAX launcher calls
`generate_batch` without them and fails); serve one from Python with
`Engine.generate_batch(prompts, vision_embeds=...)`. `--materialize`
dequantizes to a
dense tree first; without it quantized params are served packed.

Crash-safe serving: `--journal DIR` records every request's lifecycle
(ft.Journal); `--restarts N` supervises the run with ft.run_with_restarts,
each restart recovering through `serve.recover_runtime` (retired requests
are not re-run, in-flight ones replay token for token; a crash inside the
staggered submits re-submits the prompts that were never journaled);
`--resume` recovers from an existing journal; `--inject` arms the
runtime's fault points (page_alloc, decode_step, callback, kill):

    ... --journal DIR --inject kill:20 --restarts 2

Observability (paged engine, as in the JAX launcher): `--trace DIR`
writes the runtime's request events and `decode_step` / `serve.run` spans
to `DIR/serve.g<N>.trace.json` (a supervised run's restarts share one
tracer, and timelines dedup the replayed events), `--metrics DIR` its
registry to `DIR/metrics.jsonl` and `DIR/metrics.prom`:

    ... --num-blocks 8 --priorities 0,0,1,1,2,2 --trace DIR --metrics DIR
    python -m repro_torch.obs.validate --timelines --require-preempt \
        DIR/*.trace.json

Runs on the card unless `--device cpu` is given, and prints one JSON line
of run metrics.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.ckpt import (load_packed_ckpt, pack_tree, save_packed_ckpt,
                              strip_for_serving, tree_bytes, unpack_tree)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import qparams_from_numpy
from repro_torch.core import QuantSpec, materialize, quantize_model
from repro_torch.core.apply import serving_params
from repro_torch.device import resolve_device
from repro_torch.ft import (FaultInjector, Heartbeat, Journal, SimulatedKill,
                            run_with_restarts)
from repro_torch.launch.quantize import save_obs, set_precision
from repro_torch.models import BuildPlan, init_params
from repro_torch.models.model import param_count as count_params
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import (Engine, Runtime, ServeConfig, blocks_for,
                               paged_cache_bytes, recover_runtime)


def _quantize(params, cfg, plan, bits: int, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    calib = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                          device=dev)
    spec = QuantSpec(bits=bits, granularity="per_channel", lam=0.9,
                     sweeps=3, order="greedy")
    qparams, report = quantize_model(params, cfg, plan, calib, spec)
    print(f"quantized {len(report.layers)} projections; COMQ vs RTN "
          f"reconstruction improvement {report.total_improvement():.1%}")
    return qparams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--save-quantized", metavar="PATH", default=None,
                    help="save the packed quantized tree to PATH (headered "
                         "+ crc32-checksummed single file)")
    ap.add_argument("--load-quantized", metavar="PATH", default=None,
                    help="serve from a packed quantized tree on disk "
                         "instead of re-quantizing (validated header)")
    ap.add_argument("--materialize", action="store_true",
                    help="dequantize to dense before serving (default: "
                         "serve the packed QT tree)")
    ap.add_argument("--engine", choices=("paged", "static"), default="paged")
    ap.add_argument("--num-requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--mixed", action="store_true",
                    help="vary prompt lengths across requests")
    ap.add_argument("--stagger", type=int, default=0, metavar="N",
                    help="submit N requests up front, the rest one per "
                         "decode step")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--stop-token", type=int, action="append", default=[],
                    metavar="ID", help="stop-token id(s) (repeatable; paged "
                    "engine only)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="0 -> sized for num_requests at full length")
    ap.add_argument("--kv-bits", type=int, default=0, choices=(0, 4, 8),
                    help="quantize the paged KV pool: 8/4-bit page codes "
                         "with per-(layer, page, kv_head) scales, "
                         "dequantized inside the attention kernel (0 = "
                         "pages in the cache dtype; paged engine only)")
    ap.add_argument("--admission", choices=("preempt", "reserve"),
                    default="preempt")
    ap.add_argument("--priorities", default=None, metavar="CSV",
                    help="per-request priority classes (lower = more "
                         "urgent), cycled if shorter than --num-requests")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="crash-replay request journal directory "
                         "(ft.Journal; paged engine)")
    ap.add_argument("--resume", action="store_true",
                    help="recover from --journal: skip retired requests, "
                         "replay the in-flight ones")
    ap.add_argument("--restarts", type=int, default=0, metavar="N",
                    help="supervise the run: up to N restarts without "
                         "progress (retired count), each recovering from "
                         "--journal")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'page_alloc:3+7,kill:5' (ft.FaultInjector)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a Chrome-trace JSON of the run's request "
                         "events and spans to DIR (obs.Tracer; paged "
                         "engine)")
    ap.add_argument("--metrics", default=None, metavar="DIR",
                    help="write DIR/metrics.jsonl + DIR/metrics.prom "
                         "(obs.MetricsRegistry; paged engine)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    set_precision()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    plan = BuildPlan()
    if args.kv_bits:
        if args.engine == "static":
            print("note: --kv-bits quantizes the paged pool; the static "
                  "engine's dense cache ignores it")
        else:
            plan = plan.replace(kv_bits=args.kv_bits)
    if args.engine == "paged" and (cfg.attn_free or cfg.parallel_ssm_heads
                                   or cfg.family == "vlm"):
        print(f"note: {cfg.family}/attention-free archs use the dense-"
              "cache static engine (paged runtime is attention-family "
              "only; see ROADMAP)")
        args.engine = "static"
    if cfg.family == "vlm":
        raise SystemExit(
            f"{cfg.name}: the serve launcher has no source of image "
            "features for the VLM's cross layers (the JAX launcher calls "
            "Engine.generate_batch without them and fails in _run_vlm); "
            "call serve.Engine.generate_batch(prompts, vision_embeds=...) "
            "from Python instead")
    if cfg.family == "encoder":
        raise SystemExit(f"{cfg.name} is an encoder: it has no decode to "
                         "serve")
    if (args.resume or args.restarts) and not args.journal:
        raise SystemExit("--resume/--restarts need --journal DIR")
    bf16_bytes = 2 * count_params(cfg)

    params = qparams = None
    if args.load_quantized:
        blob = load_packed_ckpt(args.load_quantized)
        saved_arch = blob.get("arch")
        if saved_arch is not None and saved_arch != cfg.name:
            raise SystemExit(
                f"--load-quantized checkpoint is for arch {saved_arch!r}, "
                f"not {cfg.name!r} (pass the matching --arch/--smoke)")
        packed = qparams_from_numpy(blob["tree"], dev)
        print(f"loaded packed tree: {tree_bytes(packed):,} bytes vs "
              f"{bf16_bytes:,} bf16 "
              f"({bf16_bytes / max(tree_bytes(packed), 1):.1f}x smaller)")
        qparams = unpack_tree(packed)
    elif args.quantize:
        params = init_params(cfg, seed=0, device=dev)
        qparams = _quantize(params, cfg, plan, args.bits, dev)

    if qparams is not None and args.save_quantized:
        packed = pack_tree(strip_for_serving(qparams))
        save_packed_ckpt(args.save_quantized, packed, bits=args.bits,
                         arch=cfg.name)
        print(f"saved packed tree to {args.save_quantized}: "
              f"{tree_bytes(packed):,} bytes vs {bf16_bytes:,} bf16 "
              f"({bf16_bytes / tree_bytes(packed):.1f}x smaller)")

    packed_serve = False
    if qparams is not None:
        if args.materialize or args.engine == "static":
            params = materialize(qparams, cfg)
        else:
            params = serving_params(qparams, cfg)
            packed_serve = True
    elif params is None:
        params = init_params(cfg, seed=0, device=dev)

    rs = np.random.RandomState(0)
    lens = [args.prompt_len] * args.num_requests
    if args.mixed:
        if args.engine == "static":
            print("note: --engine static only batches equal-length "
                  "prompts; ignoring --mixed")
        else:
            lens = [max(4, int(n)) for n in
                    rs.randint(args.prompt_len // 2, args.prompt_len + 1,
                               args.num_requests)]
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    priorities = [0] * args.num_requests
    if args.priorities:
        cycle = [int(p) for p in args.priorities.split(",")]
        priorities = [cycle[i % len(cycle)] for i in range(args.num_requests)]

    t0 = time.time()
    with torch.no_grad():
        if args.engine == "static":
            engine = Engine(params, cfg, plan,
                            max_len=args.prompt_len + args.max_new,
                            device=dev)
            out = engine.generate_batch(np.stack(prompts),
                                        max_new_tokens=args.max_new,
                                        temperature=args.temperature)
            dt = time.time() - t0
            summary = {"arch": cfg.name, "engine": "static",
                       "device": str(dev), "requests": args.num_requests,
                       "new_tokens": int(out.size), "seconds": round(dt, 2),
                       "tok_per_s": round(out.size / dt, 1),
                       "sample": out[0, :8].tolist()}
            print(json.dumps(summary))
            return summary

        bucket = 1 << max(args.prompt_len - 1, 1).bit_length()
        maxb = blocks_for(bucket + args.max_new, args.block_size)
        num_blocks = args.num_blocks or maxb * min(args.num_requests, 8)
        serve_cfg = ServeConfig(max_slots=min(args.num_requests, 8),
                                block_size=args.block_size,
                                num_blocks=num_blocks,
                                buckets=(bucket // 4, bucket // 2, bucket),
                                max_blocks_per_slot=maxb,
                                policy=args.admission)
        if plan.kv_bits:
            pool_b = paged_cache_bytes(cfg, plan, num_blocks,
                                       args.block_size)
            bf16_b = paged_cache_bytes(cfg, plan.replace(kv_bits=0),
                                       num_blocks, args.block_size)
            print(f"kv pages: int{plan.kv_bits} pool {pool_b:,} bytes vs "
                  f"{bf16_b:,} bf16 ({bf16_b / pool_b:.2f}x smaller)")
        kw = dict(max_new_tokens=args.max_new, temperature=args.temperature,
                  top_k=args.top_k, top_p=args.top_p,
                  stop_tokens=tuple(args.stop_token))
        injector = FaultInjector.parse(args.inject) if args.inject else None
        tracer = Tracer(run=f"serve:{cfg.name}") if args.trace else None
        registry = (MetricsRegistry(run=f"serve:{cfg.name}")
                    if args.metrics else None)
        hb = Heartbeat(args.journal, host_id=0) if args.journal else None
        # box["rt"] is set as soon as a runtime exists, so a crash inside
        # build() still lets the supervisor close that attempt's journal
        box: Dict[str, Any] = {}

        def build(resume: bool):
            if resume:
                rt, state = recover_runtime(params, cfg, plan, args.journal,
                                            serve_cfg, injector=injector,
                                            device=dev, tracer=tracer,
                                            metrics=registry)
                box["rt"] = rt
                print(f"resume: {len(state.completed)} retired in journal, "
                      f"replaying {len(state.inflight)} in-flight")
                reqs = list(rt.scheduler.queue)
                if not args.resume:
                    # a restart of this launch: prompts map 1:1 to rids in
                    # submission order, so a prompt past max_rid crashed
                    # before its submit was journaled — submit it now
                    for p, pr in zip(prompts[state.max_rid + 1:],
                                     priorities[state.max_rid + 1:]):
                        reqs.append(rt.submit(p, priority=pr, **kw))
                return rt, reqs
            journal = Journal(args.journal) if args.journal else None
            rt = Runtime(params, cfg, plan, serve_cfg, journal=journal,
                         injector=injector, tracer=tracer, metrics=registry,
                         device=dev)
            box["rt"] = rt
            n_up_front = args.stagger if args.stagger > 0 else len(prompts)
            reqs = [rt.submit(p, priority=pr, **kw)
                    for p, pr in zip(prompts[:n_up_front],
                                     priorities[:n_up_front])]
            for p, pr in zip(prompts[n_up_front:], priorities[n_up_front:]):
                rt.step()
                reqs.append(rt.submit(p, priority=pr, **kw))
            return rt, reqs

        if args.restarts > 0:
            def attempt(_):
                prev = box.pop("rt", None)
                if prev is not None:
                    # drop the dead attempt's pool before the next one
                    # allocates its own
                    prev.journal.close()
                    del prev
                    gc.collect()
                # a crash inside build() has already journaled some
                # requests, so decide resume from the journal itself
                resume = args.resume or bool(
                    Journal.replay(args.journal).records)
                rt, reqs = build(resume)
                box["reqs"] = reqs
                hb.beat(rt.steps, metrics=rt.metrics_snapshot())
                out = rt.run()
                hb.beat(rt.steps, metrics=rt.metrics_snapshot())
                return out

            def progress():
                return len(Journal.replay(args.journal).completed)

            metrics = run_with_restarts(
                attempt, progress, max_restarts=args.restarts,
                exceptions=(RuntimeError, SimulatedKill), backoff_s=0.0)
            rt, reqs = box["rt"], box["reqs"]
        else:
            rt, reqs = build(args.resume)
            metrics = rt.run()
            if hb is not None:
                hb.beat(rt.steps, metrics=rt.metrics_snapshot())
    save_obs(tracer, registry, args.trace, args.metrics, "serve")

    metrics.update({
        "arch": cfg.name, "engine": "paged", "device": str(dev),
        "admission": args.admission, "kv_bits": plan.kv_bits,
        "packed_qt": packed_serve,
        "prompt_lens": [int(r.prompt_len) for r in reqs],
        "ttft_s": [round(t, 4) for t in metrics["ttft_s"]],
        "sample": reqs[0].out_tokens[:8] if reqs else [],
    })
    if injector is not None:
        metrics["faults_fired"] = injector.fired
    metrics = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in metrics.items()}
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
