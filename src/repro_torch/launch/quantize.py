"""COMQ quantization launcher (port of `repro.launch.quantize`):
calibrate → quantize → pack, then the fp and quantized eval loss.

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch qwen2-7b \
        --smoke --method comq_blocked --bits 4 --device cpu

    # per-leaf mixed precision, or a bits-per-param budget
    ... --policy "*.w_down=8,first=8,last=8,kv=8"
    ... --bits-budget 3.5 --policy kv=4

    # crash-safe: journal every solved leaf, supervise with restarts, and
    # resume after a kill injected at the end of the second layer
    ... --journal DIR --inject kill:2 --restarts 3 --save-packed q.qpk

`--journal DIR` journals every solved leaf durably (solve → spill →
journal) and runs the walk under `ft.run_with_restarts`: `--restarts N`
allows N restarts without progress (journaled-leaf count), each resuming
from the journal after `QuantJournal.check_integrity`, which re-applies
the journaled leaves bit for bit instead of solving them; a
`ft.Heartbeat` in the journal directory beats after each layer.
`--inject` arms the pipeline's fault points (`ft.FaultInjector.parse`).
`--trace DIR` records the walk's `layer` and `leaf_solve` spans
(obs.Tracer; each traced group waits for its codes, so the report's
wall_seconds are measured) into `DIR/quantize.g<N>.trace.json`;
`--metrics DIR` writes the run's registry to `DIR/metrics.jsonl` and
`DIR/metrics.prom`, and a journaled run's heartbeat carries its snapshot.
Check them with `python -m repro_torch.obs.validate` and
`python -m repro_torch.obs.report DIR`:

    ... --device cpu --trace /tmp/obs_q/trace --metrics /tmp/obs_q/metrics

    # distributed, as the JAX launcher: batch over "data", solve columns
    # over a "model" axis of 2 (4 ranks: a (2, 2) mesh)
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.quantize --arch qwen2-7b --smoke \
        --method comq_blocked --shard-data --shard-solve 2

`--shard-data` shards the calibration batch over the mesh's "data" axis
(one Gram all-reduce a tap); `--shard-solve TP` column-shards the
per-channel comq_blocked / rtn solves over a "model" axis of TP (other
methods print JAX's note and solve replicated), the data axis taking the
ranks it leaves with `--shard-data`, else 1. The launcher runs one
process per rank under `python -m torch.distributed.run` (or as a world
of one without it) and exits 2 when the world is not the mesh's size.
`--dist-backend` is nccl on the card (a card per rank) and gloo on the
CPU; ranks that share one card need gloo. Rank 0 alone prints the
summary and writes --out-dir, --save-packed, --trace, --metrics and the
journal; every rank reads the journal on resume.
`--out-dir DIR` saves the packed tree as a `CheckpointManager` step 0
with the policy metadata (the JAX launcher always saves one, to a
default directory; the port only when asked). A resumed run's
`.qpk` is byte-identical to an uninterrupted run's on the same device.

A VLM (llama-3.2-vision-90b) calibrates and evaluates on random image
features (calib_batch, n_vision_tokens, vision_dim), bf16 normals from a
seeded generator, as the JAX launcher does. An encoder (vit-base-16) exits
2: the JAX package has no encoder walk to port.

Runs on the card unless `--device cpu` is given. Prints the JAX
launcher's JSON summary keys. `quantize_and_eval` is the same run as a
function of a ModelConfig, and `quantize_supervised` its crash-safe walk.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.ckpt import (CheckpointManager, pack_tree, policy_extra,
                              save_packed_ckpt, tree_bytes)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (QuantPolicy, QuantSpec, materialize,
                              parse_policy, policy_from_budget,
                              quantize_model)
from repro_torch.core.pipeline import _col_shardable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft import (FaultInjector, Heartbeat, QuantJournal,
                            run_with_restarts)
from repro_torch.models import BuildPlan, init_params, lm_loss
from repro_torch.obs import MetricsRegistry, Tracer, next_trace_path

def set_precision() -> None:
    """Full-f32 matmuls and convolutions on the card (no TF32): Grams and
    the solver's trailing updates are f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class QuantizeRun:
    summary: Dict[str, Any]
    params: Any
    qparams: Any
    report: Any
    spec: Any                   # the QuantSpec or the QuantPolicy solved
    plan: BuildPlan             # with the policy's kv= rider applied
    calib_tokens: torch.Tensor
    eval_tokens: torch.Tensor
    seconds: float              # quantize_model, synchronized, unrounded
    alloc: Optional[Dict[str, int]] = None   # the --bits-budget allocation
    sizes: Optional[Dict[str, int]] = None
    vision_embeds: Optional[torch.Tensor] = None   # a VLM's image features


def _randint(seed: int, shape, high: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, high, shape, generator=gen, device=dev)


def vision_features(cfg, batch: int, dev) -> torch.Tensor:
    """A VLM's stand-in image features (batch, n_vision_tokens,
    vision_dim): bf16 standard normals from a generator seeded 0 (the
    vision frontend is a stub in both packages)."""
    ca = cfg.cross_attn
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randn(batch, ca.n_vision_tokens, ca.vision_dim,
                       generator=gen, device=dev).to(torch.bfloat16)


def resolve_policy(params, cfg, plan, tokens, base: QuantSpec,
                   policy: Optional[str] = None, bits_budget: float = 0.0):
    """The launcher's --policy / --bits-budget resolution, as the JAX
    launcher does it: a budget allocation supersedes the bit rules but
    keeps the kv= rider; kv=8 turns on the int8 static cache and int8
    pages, kv=4 4-bit pages only. Returns (spec or policy, plan, alloc,
    sizes)."""
    spec, alloc, sizes = base, None, None
    parsed = parse_policy(policy, base) if policy else None
    if bits_budget:
        if parsed is not None and (parsed.rules
                                   or parsed.first_layer_bits is not None
                                   or parsed.last_layer_bits is not None):
            print("# note: --bits-budget supersedes the --policy bit "
                  "rules; only its kv= rider is kept")
        kv = parsed.kv_bits if parsed is not None else 0
        spec, alloc, sizes = policy_from_budget(params, cfg, plan, tokens,
                                                base, bits_budget,
                                                kv_bits=kv)
        hist: Dict[int, int] = {}
        for b in alloc.values():
            hist[b] = hist.get(b, 0) + 1
        print(f"# bit allocation under {bits_budget} bits/param: "
              f"{dict(sorted(hist.items()))}")
    elif parsed is not None:
        spec = parsed
    if spec is not base and spec.kv_bits:
        if spec.kv_bits not in (4, 8):
            raise ValueError(f"kv={spec.kv_bits} unsupported (0, 4 or 8)")
        if spec.kv_bits == 8:
            plan = plan.replace(cache_quant=True)
        plan = plan.replace(kv_bits=spec.kv_bits)
    return spec, plan, alloc, sizes


def quantize_supervised(params, cfg, plan, tokens, spec, *, journal: str,
                        resume: bool = False, restarts: int = 0,
                        injector=None, progress_cb=None, metrics=None,
                        mesh=None, **kw):
    """`quantize_model` journaled in `journal` under `run_with_restarts`,
    as the launcher runs it: up to `restarts` restarts without progress
    (the journaled-leaf count), each attempt resuming whenever the
    journal already holds leaves (after `QuantJournal.check_integrity`),
    a `Heartbeat` in the journal directory beating after each layer
    (with `metrics.snapshot()` when a registry is given) before
    `progress_cb(layer)`. A failed attempt's frames are collected before
    the next one allocates, so a retry starts from the memory one clean
    run holds. Under a `mesh` every rank runs this and rank 0 alone beats.
    `kw` goes to `quantize_model`."""
    from repro_torch.dist import is_rank0
    from repro_torch.dist.world import barrier
    hb = Heartbeat(journal, host_id=0) if is_rank0() else None
    box: Dict[str, Any] = {"attempts": 0}

    def on_layer(layer: int) -> None:
        if hb is not None:
            hb.beat(layer, metrics=(metrics.snapshot()
                                    if metrics is not None else None))
        if progress_cb is not None:
            progress_cb(layer)

    def attempt(_):
        if box["attempts"]:
            gc.collect()
        box["attempts"] += 1
        again = resume or bool(QuantJournal.replay(journal).leaves)
        if again:
            QuantJournal.check_integrity(journal)
        box["out"] = quantize_model(params, cfg, plan, tokens, spec,
                                    journal=journal, resume=again,
                                    injector=injector, progress_cb=on_layer,
                                    metrics=metrics, mesh=mesh, **kw)

    def progress():
        if mesh is not None:
            barrier()      # rank 0's journal writes are done: one count
        return len(QuantJournal.replay(journal).leaves)

    run_with_restarts(attempt, progress, max_restarts=restarts,
                      exceptions=(RuntimeError,), backoff_s=0.0)
    return box["out"]


def quantize_and_eval(cfg, *, bits: int = 4,
                      granularity: str = "per_channel",
                      order: str = "greedy", sweeps: int = 3,
                      lam: float = 0.9, method: str = "comq",
                      calib_batch: int = 8, calib_seq: int = 128,
                      policy: Optional[str] = None, bits_budget: float = 0.0,
                      guards: bool = True, propagation: str = "staged",
                      save_packed: Optional[str] = None,
                      out_dir: Optional[str] = None,
                      journal: Optional[str] = None, resume: bool = False,
                      restarts: int = 0, injector=None, tracer=None,
                      metrics=None, mesh=None,
                      device: DeviceLike = None) -> QuantizeRun:
    """Init `cfg` from seed 0, quantize it on random calibration ids
    (seed 0) under `--bits` or the policy, and evaluate fp vs quantized
    loss on a held-out batch (seed 7) — the JAX launcher's run. With
    `journal` the walk is `quantize_supervised`'s; `tracer` and `metrics`
    (obs) go to `quantize_model`. Under a `mesh` (repro_torch.dist) every
    rank calls this alike: the walk is sharded, every rank evaluates, and
    rank 0 alone writes `out_dir` and `save_packed`."""
    from repro_torch.dist import is_rank0, mesh_shape
    dev = resolve_device(device)
    writer = mesh is None or is_rank0()
    set_precision()
    params = init_params(cfg, seed=0, device=dev)
    tokens = _randint(0, (calib_batch, calib_seq), cfg.vocab_size, dev)
    ve = (vision_features(cfg, calib_batch, dev)
          if cfg.family == "vlm" else None)
    base = QuantSpec(bits=bits, granularity=granularity, lam=lam,
                     sweeps=sweeps, order=order)
    spec, plan, alloc, sizes = resolve_policy(params, cfg, BuildPlan(),
                                              tokens, base, policy,
                                              bits_budget)
    t0 = time.time()
    kw = dict(method=method, propagation=propagation, guards=guards,
              vision_embeds=ve, tracer=tracer, mesh=mesh)
    if journal:
        qparams, report = quantize_supervised(
            params, cfg, plan, tokens, spec, journal=journal, resume=resume,
            restarts=restarts, injector=injector, metrics=metrics, **kw)
    else:
        qparams, report = quantize_model(params, cfg, plan, tokens, spec,
                                         injector=injector, metrics=metrics,
                                         **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    packed = pack_tree(qparams["__qlayers__"])
    if out_dir and writer:
        CheckpointManager(out_dir, keep=2).save(
            0, packed, extra=policy_extra(policy=spec, arch=cfg.name,
                                          bits=bits))
    if save_packed and writer:
        save_packed_ckpt(save_packed, packed,
                         **policy_extra(policy=spec, arch=cfg.name,
                                        bits=bits))

    ev = _randint(7, (calib_batch, calib_seq), cfg.vocab_size, dev)
    batch = {"tokens": ev, "labels": ev}
    if ve is not None:
        batch["vision_embeds"] = ve
    with torch.no_grad():
        fp_loss = float(lm_loss(params, cfg, plan, batch)[0])
        q_loss = float(lm_loss(materialize(qparams, cfg), cfg, plan,
                               batch)[0])
    dense_bytes = tree_bytes(params)
    summary = {
        "arch": cfg.name, "method": method, "bits": bits,
        "mixed_policy": (isinstance(spec, QuantPolicy)
                         and not spec.is_uniform()),
        "bits_budget": bits_budget or None,
        "propagation": propagation,
        "data_shards": mesh_shape(mesh).get("data", 1),
        "model_shards": mesh_shape(mesh).get("model", 1),
        "order": order, "granularity": granularity,
        "layers_quantized": len(report.layers),
        "comq_vs_rtn_error_improvement": round(report.total_improvement(), 4),
        "fp_loss": round(fp_loss, 4), "quant_loss": round(q_loss, 4),
        "seconds": round(dt, 1),
        "ckpt_bytes": tree_bytes(packed),
        "dense_bytes": dense_bytes,
        "compression": round(dense_bytes / max(tree_bytes(packed), 1), 1),
        "guard_events": len(report.guard_events),
        "resumed_leaves": report.resumed_leaves,
        "faults_fired": len(injector.fired) if injector is not None else 0,
    }
    return QuantizeRun(summary, params, qparams, report, spec, plan, tokens,
                       ev, dt, alloc, sizes, ve)


def save_obs(tracer, registry, trace_dir, metrics_dir, prefix: str) -> None:
    """The launchers' obs sinks, as the JAX launchers write them: the trace
    to `next_trace_path(trace_dir, prefix)`, the registry to
    `metrics_dir/metrics.jsonl` and `metrics.prom`."""
    if tracer is not None:
        path = next_trace_path(trace_dir, prefix)
        tracer.save(path)
        print(f"# trace: {path} ({len(tracer.events)} events)")
    if registry is not None:
        registry.dump_jsonl(os.path.join(metrics_dir, "metrics.jsonl"))
        registry.dump_prometheus(os.path.join(metrics_dir, "metrics.prom"))
        print(f"# metrics: {metrics_dir}/metrics.jsonl + metrics.prom")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quantize")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--granularity", default="per_channel",
                    choices=["per_channel", "per_layer"])
    ap.add_argument("--order", default="greedy",
                    choices=["greedy", "cyclic", "greedy_shared"])
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--lam", type=float, default=0.9)
    ap.add_argument("--method", default="comq",
                    choices=["comq", "comq_blocked", "rtn", "gptq"])
    ap.add_argument("--calib-batch", type=int, default=8)
    ap.add_argument("--calib-seq", type=int, default=128)
    ap.add_argument("--propagation", default="staged",
                    choices=["staged", "legacy"],
                    help="staged = one forward per layer (default); "
                         "legacy = the two-forward schedule")
    ap.add_argument("--policy", default=None, metavar="RULES",
                    help="per-leaf mixed-precision rules, e.g. "
                         "'*.w_down=8,first=8,last=8,kv=8' — patterns "
                         "match '{layer}.{leaf}' then the bare leaf name "
                         "(core/policy.py; --bits stays the base width)")
    ap.add_argument("--bits-budget", type=float, default=0.0, metavar="BPP",
                    help="allocate per-leaf bit widths (2/3/4/8) under "
                         "this bits-per-param budget with the greedy "
                         "backprop-free knapsack on layerwise H-space "
                         "errors (overrides the --policy bit rules)")
    ap.add_argument("--no-guards", action="store_true",
                    help="disable the numeric guards (core/guards.py); "
                         "healthy runs give the same codes either way")
    ap.add_argument("--save-packed", default=None, metavar="PATH",
                    help="save the packed tree as one atomic checksummed "
                         "file (readable by the JAX package; byte-"
                         "deterministic, so a resumed run's equals an "
                         "uninterrupted run's)")
    ap.add_argument("--out-dir", default=None, metavar="DIR",
                    help="save the packed tree as CheckpointManager step 0 "
                         "with the policy metadata (none when omitted)")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="journal directory: durably record every solved "
                         "leaf so a crashed run resumes bit-identically "
                         "(ft.QuantJournal)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --journal (also implied when the "
                         "journal already holds leaves)")
    ap.add_argument("--restarts", type=int, default=0, metavar="N",
                    help="restart up to N times without progress "
                         "(journaled-leaf count), resuming from --journal")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. 'kill:2' or "
                         "'leaf_solve:3,ckpt_write:1' (ft.FaultInjector; "
                         "points: gram_accumulate, leaf_solve, ckpt_write, "
                         "kill, nan_tap)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a Chrome-trace JSON of the walk's layer / "
                         "leaf_solve spans to DIR (obs.Tracer)")
    ap.add_argument("--metrics", default=None, metavar="DIR",
                    help="write DIR/metrics.jsonl + DIR/metrics.prom "
                         "(obs.MetricsRegistry)")
    ap.add_argument("--shard-data", action="store_true",
                    help="shard the calibration batch over the mesh data "
                         "axis (repro_torch.dist: one Gram all-reduce per "
                         "tap)")
    ap.add_argument("--shard-solve", type=int, default=0, metavar="TP",
                    help="shard solve columns over a model axis of this "
                         "size (0 = off; with --shard-data the remaining "
                         "ranks form the data axis). Zero-communication "
                         "for per-channel comq_blocked/rtn; other methods "
                         "keep replicated solves.")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend with --shard-data / "
                         "--shard-solve: nccl (default on the card; a card "
                         "per rank) or gloo (default on the CPU; ranks "
                         "sharing one card)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def launcher_mesh(ap, args):
    """The JAX launcher's mesh over this world: --shard-solve TP gives
    (data, TP) with the data axis every rank TP leaves under --shard-data,
    else 1; --shard-data alone a ("data",) mesh of every rank. A world
    that is not the mesh's size exits 2. Returns (mesh, device, started)."""
    from repro_torch import dist as rd
    dev, started = rd.init_world(args.dist_backend, args.device)
    try:
        if args.shard_solve:
            mesh = rd.calib_mesh(model=args.shard_solve,
                                 data=None if args.shard_data else 1)
        else:
            mesh = rd.data_mesh()
    except ValueError as e:
        world = torch.distributed.get_world_size()
        rd.close_world(started)
        ap.exit(2, f"{ap.prog}: {e} (world of {world} ranks"
                   f"{'' if args.shard_data else ', --shard-data off'})\n")
    return mesh, dev, started


def main(argv=None) -> Dict[str, Any]:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.restarts and not args.journal:
        raise SystemExit("--restarts needs --journal (resume source)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encoder":
        ap.exit(2, f"{ap.prog}: {cfg.name} is an encoder, and quantize_model "
                   "has no encoder walk (the JAX package's starts from "
                   "embed_tokens, which an encoder does not have)\n")
    mesh, started, writer, device = None, False, True, args.device
    if args.shard_data or args.shard_solve:
        from repro_torch.dist import is_rank0
        mesh, device, started = launcher_mesh(ap, args)
        writer = is_rank0()
        if writer and args.shard_solve and not _col_shardable(
                QuantSpec(bits=args.bits, granularity=args.granularity),
                args.method):
            print(f"# note: method={args.method} granularity="
                  f"{args.granularity} is not column-shardable; solves "
                  "stay replicated")
    tracer = (Tracer(run=f"quantize:{cfg.name}") if args.trace and writer
              else None)
    registry = (MetricsRegistry(run=f"quantize:{cfg.name}")
                if args.metrics and writer else None)
    try:
        run = quantize_and_eval(
            cfg, bits=args.bits, granularity=args.granularity,
            order=args.order, sweeps=args.sweeps, lam=args.lam,
            method=args.method, calib_batch=args.calib_batch,
            calib_seq=args.calib_seq, policy=args.policy,
            bits_budget=args.bits_budget, guards=not args.no_guards,
            propagation=args.propagation, save_packed=args.save_packed,
            out_dir=args.out_dir, journal=args.journal, resume=args.resume,
            restarts=args.restarts,
            injector=(FaultInjector.parse(args.inject) if args.inject
                      else None),
            tracer=tracer, metrics=registry, mesh=mesh, device=device)
    finally:
        from repro_torch.dist import close_world
        close_world(started)
    if writer:
        save_obs(tracer, registry, args.trace, args.metrics, "quantize")
        print(json.dumps(run.summary))
    return run.summary


if __name__ == "__main__":
    main()
