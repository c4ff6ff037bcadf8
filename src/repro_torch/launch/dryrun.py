"""Dry run of every (architecture x input shape) cell on JAX's production
mesh, on the meta device (port of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \
        --shape train_4k [--multi-pod] [--override key=value ...]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Each cell builds its params at `BuildPlan(tp=16)` on the meta device (no
tensor is allocated: the meta device carries shapes and dtypes, as JAX's
dry run traces on fake CPU devices): f32 for a train shape, bf16 for the
serving ones, fake-quantized QT leaves with `--override quantized_bits=4`.
It assigns every leaf JAX's partition spec on the 16 x 16 ("data",
"model") mesh, or 2 x 16 x 16 with a leading "pod" axis, as JAX's
`lower_cell` does: params by `param_specs`, the train state by
`_opt_specs` (int8 moments for `BIG_ARCHES_INT8_OPT`), inputs by
`input_batch_specs`, caches by `cache_specs`. It then runs the step once
on meta under `roofline.analysis.count_cost`: the train step with
`default_microbatches`, the prefill, or one decode step.

One JSON file a cell goes to experiments/dryrun_torch/
<arch>__<shape>__<mesh>[__overrides].json, with JAX's keys where a
counterpart exists:

* memory.argument_bytes / output_bytes / alias_bytes: Σ of one rank's
  slice of every argument and output leaf under its spec, exact. The
  train state and the decode cache are donated (JAX's donate_argnums), so
  they alias their outputs. memory.temp_bytes is null: there is no buffer
  assignment to read temporaries from, so per_device_total_gb =
  (arguments + outputs - aliases) / 2**30 excludes them.
* counted.flops_per_device / bytes_per_device: the counted global step
  over the chip count (ideal division: no partitioner decides what each
  rank recomputes or moves). counted.collective_bytes is {} and
  collectives_counted false: there is no partitioner to read collectives
  from.

`python -m repro_torch.roofline.report --dir experiments/dryrun_torch`
renders the table. JAX's `attn_block_size` override (the block of its XLA
pair scan) has no counterpart; a cell records it and ignores it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.dist.sharding import (P, batch_dim_spec, cache_specs,
                                       dp_size, input_batch_specs,
                                       local_bytes, make_constrain,
                                       param_specs, tp_size)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import BuildPlan
from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      input_specs, prefill)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

BIG_ARCHES_INT8_OPT = {"llama4-maverick-400b-a17b", "mistral-large-123b",
                       "llama-3.2-vision-90b", "deepseek-67b"}
IGNORED_OVERRIDES = ("attn_block_size",)
META = torch.device("meta")


def default_microbatches(gb: int, dp: int, per_shard: int = 2) -> int:
    local = max(gb // dp, 1)
    return max(1, local // per_shard)


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def build_plan(cfg, mesh, shape, overrides) -> BuildPlan:
    seq_shard = overrides.get("seq_shard")
    if seq_shard is None:
        seq_shard = (shape.kind == "train" and cfg.family != "encoder"
                     and shape.seq_len % tp_size(mesh) == 0)
    constrain = make_constrain(
        mesh, shape.global_batch, seq_shard=seq_shard,
        block_gather=overrides.get("block_gather", False),
        ffn_shard=overrides.get("ffn_shard", False))
    return BuildPlan(
        tp=tp_size(mesh),
        moe_token_chunk=overrides.get("moe_token_chunk", 4096),
        remat=(shape.kind == "train"),
        cache_quant=bool(overrides.get("cache_quant", False)),
        constrain=constrain)


def _opt_specs(state, pspecs):
    """Specs for the whole train state from the param specs (JAX's
    `_opt_specs`): int8 moment dicts ({"q", "scale"[, "ef"]}) give "q" the
    param's spec and replicate the last dim of the blockwise "scale" and
    the packed "ef" residual; f32 moments take the param's spec; the step
    is replicated; an int8_ef "grad_err" takes the params' specs."""
    def moment(m, ps):
        if isinstance(m, dict) and {"q", "scale"} <= set(m):
            small = P(*ps[:-1], None) if len(ps) else ps
            out = {"q": ps, "scale": small}
            if "ef" in m:
                out["ef"] = small
            return out
        if isinstance(m, dict):
            return {k: moment(m[k], ps[k]) for k in m}
        if isinstance(m, list):
            return [moment(a, b) for a, b in zip(m, ps)]
        return ps

    out = {"params": pspecs,
           "opt": {"step": P(),
                   "m": moment(state["opt"]["m"], pspecs),
                   "v": moment(state["opt"]["v"], pspecs)}}
    if "grad_err" in state:
        out["grad_err"] = pspecs
    return out


def _to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_bf16(v) for v in tree]
    return tree.to(torch.bfloat16) if tree.dtype == torch.float32 else tree


def _replicated(tree) -> int:
    """Bytes of outputs every rank holds whole (the step's metrics)."""
    if isinstance(tree, dict):
        return sum(_replicated(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    from repro_torch.roofline.analysis import count_cost
    overrides = overrides or {}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    plan = build_plan(cfg, mesh, shape, overrides)
    gb = shape.global_batch
    t0 = time.time()

    params = init_params(cfg, plan, device=META)
    if shape.kind != "train":
        # serving runs from a bf16 inference checkpoint
        params = _to_bf16(params)
    pspecs = param_specs(params, mesh)
    qbits = overrides.get("quantized_bits", 0)
    if qbits and shape.kind != "train":
        from repro_torch.core.apply import fake_quantize_params
        params = fake_quantize_params(params, cfg, plan, bits=qbits)
        pspecs = param_specs(params, mesh)
    specs = input_specs(cfg, shape, plan)
    inputs = {k: v for k, v in specs.items() if k != "cache"}
    bspecs = input_batch_specs(inputs, mesh, gb)

    with torch.no_grad() if shape.kind != "train" else torch.enable_grad():
        if shape.kind == "train":
            from repro_torch.configs.base import RunConfig
            from repro_torch.optim import AdamWConfig
            from repro_torch.train.train_step import (init_train_state,
                                                      make_train_step)
            moment_dtype = overrides.get(
                "moment_dtype",
                "int8" if arch in BIG_ARCHES_INT8_OPT else "float32")
            adamw_cfg = AdamWConfig(moment_dtype=moment_dtype)
            run_cfg = RunConfig(
                arch=arch, shape=shape_name,
                microbatches=overrides.get(
                    "microbatches",
                    default_microbatches(gb, dp_size(mesh))))
            state = init_train_state(params, adamw_cfg, run_cfg)
            ospecs = _opt_specs(state, pspecs)
            state_bytes = local_bytes(state, ospecs, mesh)
            args = state_bytes + local_bytes(inputs, bspecs, mesh)
            step_fn = make_train_step(cfg, plan, run_cfg, adamw_cfg)
            out = {}
            cost = count_cost(lambda: out.update(
                zip(("state", "metrics"), step_fn(state, inputs))))
            outs = (local_bytes(out["state"], ospecs, mesh)
                    + _replicated(out["metrics"]))
            alias = state_bytes
        elif shape.kind == "prefill":
            b = batch_dim_spec(mesh, gb)
            cache = init_cache(cfg, plan, gb, shape.seq_len, device=META)
            args = (local_bytes(params, pspecs, mesh)
                    + local_bytes(inputs, bspecs, mesh))
            out = {}
            cost = count_cost(lambda: out.update(zip(
                ("logits", "cache"),
                prefill(params, cfg, plan, inputs["tokens"],
                        vision_embeds=inputs.get("vision_embeds")))))
            outs = (local_bytes(out["logits"], P(b, "model"), mesh)
                    + local_bytes(cache, cache_specs(cache, mesh, gb), mesh))
            alias = 0
        else:   # decode
            b = batch_dim_spec(mesh, gb)
            cache = specs["cache"]
            cspecs = cache_specs(cache, mesh, gb)
            cache_bytes = local_bytes(cache, cspecs, mesh)
            args = (local_bytes(params, pspecs, mesh) + cache_bytes
                    + local_bytes(inputs["tokens"], bspecs["tokens"], mesh)
                    + _replicated(inputs["pos"]))
            out = {}
            cost = count_cost(lambda: out.update(zip(
                ("logits", "cache"),
                decode_step(params, cfg, plan, cache, inputs["tokens"],
                            shape.seq_len - 1))))
            outs = (local_bytes(out["logits"], P(b, "model"), mesh)
                    + cache_bytes)
            alias = cache_bytes
    t_count = time.time() - t0
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
        "overrides": overrides, "device": "meta",
        "ignored_overrides": [k for k in IGNORED_OVERRIDES
                              if k in overrides],
        "count_s": round(t_count, 1),
        "memory": {
            "argument_bytes": int(args),
            "output_bytes": int(outs),
            "alias_bytes": int(alias),
            "temp_bytes": None,
            "per_device_total_gb": round((args + outs - alias) / 2**30, 3),
            "note": "exact per-rank shard bytes of arguments and outputs; "
                    "excludes temporaries (no buffer assignment)",
        },
        "counted": {
            "flops_per_device": cost.flops / chips,
            "bytes_per_device": cost.bytes_accessed / chips,
            "collective_bytes": {},
            "collectives_counted": False,
            "note": "the counted global step divided by the chip count "
                    "(ideal division); no partitioner, so no collectives",
        },
    }


def cell_tag(arch, shape_name, multi_pod, overrides=None) -> str:
    tag = f"{arch}__{shape_name}__{mesh_name(multi_pod)}"
    if overrides:
        tag += "__" + "_".join(f"{k}-{v}" for k, v in
                               sorted(overrides.items()))
    return tag


def run_cell(arch, shape_name, multi_pod, overrides=None, out_dir=OUT_DIR):
    tag = cell_tag(arch, shape_name, multi_pod, overrides)
    try:
        res = lower_cell(arch, shape_name, multi_pod=multi_pod,
                         overrides=overrides)
        status = "ok"
    except Exception as e:
        res = {"arch": arch, "shape": shape_name,
               "mesh": mesh_name(multi_pod),
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        status = "FAIL"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    mem = res.get("memory", {}).get("per_device_total_gb", "-")
    print(f"[{status}] {tag} mem/dev={mem}GB (excl. temporaries) "
          f"count={res.get('count_s', '-')}s", flush=True)
    if status == "FAIL":
        print(res["error"], flush=True)
    return res


def all_cells():
    """JAX's `--all` list: every registered arch but the encoder, at each
    of its runnable shapes."""
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        if cfg.family == "encoder":
            continue  # the paper's own arch: a separate smoke/bench path
        for s in shapes_for(cfg):
            cells.append((arch, s.name))
    return cells


def parse_overrides(items):
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        if v in ("true", "false"):
            v = v == "true"
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--override", action="append", default=[],
                    help="key=value (int/bool/str) plan overrides")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    failed = 0
    for mp in meshes:
        for arch, shape_name in cells:
            res = run_cell(arch, shape_name, mp, overrides or None,
                           args.out_dir)
            failed += "error" in res
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
