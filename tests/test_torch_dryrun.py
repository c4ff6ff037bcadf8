"""The dry run (repro_torch.launch.dryrun) on the meta device: `run_cell`
for qwen2-7b at each of the four input shapes and for one int8-moment
MoE train cell (llama4-maverick-400b-a17b, a big arch) writes JSON that
`roofline.report` reads, with no CUDA call; its argument, output and
alias bytes equal those summed from JAX's `eval_shape` trees under JAX's
specs (JAX's `lower_cell`: the train state and the decode cache donated);
and `--all` lists JAX's cells.

The train cells run one microbatch (and maverick's experts one token
chunk) instead of `default_microbatches`: the bytes do not depend on it,
and the counted step's Python dispatch on meta would take minutes here.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.dist import sharding as js
from repro.models import BuildPlan as JPlan
from repro.models import model as jm
from repro_torch.launch import dryrun

torch.set_num_threads(2)

FAST = {"microbatches": 1}
CELLS = [("qwen2-7b", "train_4k", FAST), ("qwen2-7b", "prefill_32k", None),
         ("qwen2-7b", "decode_32k", None), ("qwen2-7b", "long_500k", None),
         ("llama4-maverick-400b-a17b", "train_4k",
          {**FAST, "moe_token_chunk": 1 << 20})]
MESH = AbstractMesh((16, 16), ("data", "model"))


def _bytes(tree, specs):
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(sp)
    return sum(math.prod(JNamed(MESH, s).shard_shape(l.shape))
               * np.dtype(l.dtype).itemsize for l, s in zip(leaves, sp))


def _jax_memory(arch, shape_name):
    """(argument, output, alias) bytes a device of JAX's lower_cell,
    summed from its eval_shape trees and its specs."""
    from repro.launch.dryrun import BIG_ARCHES_INT8_OPT, _opt_specs
    cfg, shape = jget_config(arch), JSHAPES[shape_name]
    plan = JPlan(tp=16)
    gb = shape.global_batch
    params = jax.eval_shape(lambda k: jm.init_params(k, cfg, plan),
                            jax.random.PRNGKey(0))
    if shape.kind != "train":
        params = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
            if s.dtype == jnp.float32 else s, params)
    pspecs = js.param_specs(params, MESH)
    specs = jm.input_specs(cfg, shape, plan)
    inputs = {k: v for k, v in specs.items() if k != "cache"}
    bspecs = js.input_batch_specs(inputs, MESH, gb)
    b = js.batch_dim_spec(MESH, gb)
    if shape.kind == "train":
        from repro.configs.base import RunConfig
        from repro.optim import AdamWConfig
        from repro.train.train_step import init_train_state
        acfg = AdamWConfig(moment_dtype="int8" if arch in BIG_ARCHES_INT8_OPT
                           else "float32")
        state = jax.eval_shape(
            lambda p: init_train_state(p, acfg, RunConfig(arch=arch)),
            params)
        sb = _bytes(state, _opt_specs(state, pspecs))
        # the metrics: loss, grad_norm, lr (f32) and step (int32)
        return sb + _bytes(inputs, bspecs), sb + 16, sb
    logits = jax.ShapeDtypeStruct((gb, plan.vocab_padded(cfg)),
                                  jnp.dtype(cfg.compute_dtype))
    lb = _bytes(logits, JP(b, "model"))
    cache = jax.eval_shape(lambda: jm.init_cache(cfg, plan, gb,
                                                 shape.seq_len))
    cb = _bytes(cache, js.cache_specs(cache, MESH, gb))
    args = _bytes(params, pspecs) + _bytes(inputs, bspecs)
    if shape.kind == "prefill":
        return args, lb + cb, 0
    return args + cb, lb + cb, cb


@pytest.fixture()
def no_cuda(monkeypatch):
    """Any CUDA initialization raises."""
    def refuse(*a, **k):
        raise AssertionError("the dry run touched CUDA")
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)


@pytest.mark.parametrize("arch,shape,overrides", CELLS)
def test_run_cell_bytes_match_jax_on_meta(tmp_path, no_cuda, arch, shape,
                                          overrides):
    res = dryrun.run_cell(arch, shape, False, overrides, str(tmp_path))
    assert "error" not in res, res.get("traceback")
    tag = dryrun.cell_tag(arch, shape, False, overrides)
    with open(tmp_path / f"{tag}.json") as f:
        saved = json.load(f)
    assert saved["device"] == "meta" and saved["mesh"] == "16x16"
    mem = saved["memory"]
    args, outs, alias = _jax_memory(arch, shape)
    assert (mem["argument_bytes"], mem["output_bytes"],
            mem["alias_bytes"]) == (args, outs, alias)
    assert mem["temp_bytes"] is None
    assert mem["per_device_total_gb"] == round(
        (args + outs - alias) / 2 ** 30, 3)
    counted = saved["counted"]
    assert counted["collectives_counted"] is False
    assert counted["collective_bytes"] == {}
    assert counted["flops_per_device"] > 0 and counted["bytes_per_device"] > 0
    from repro_torch.roofline import report
    row = report.fmt_cell(saved)
    assert row["collective_s"] is None and row["mem_gb"] == \
        mem["per_device_total_gb"]


def test_report_prints_counted_cells_with_na(tmp_path, capsys):
    dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k",
                 "--both-meshes", "--override", "attn_block_size=256",
                 "--out-dir", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["qwen2-7b__decode_32k__16x16__attn_block_size-256.json",
                     "qwen2-7b__decode_32k__2x16x16__attn_block_size-256.json"]
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["ignored_overrides"] == ["attn_block_size"]
    capsys.readouterr()
    from repro_torch.roofline import report
    report.main(["--dir", str(tmp_path)])
    rows = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("| qwen2-7b")]
    assert len(rows) == 2
    for row in rows:
        assert row.split("|")[7].strip() == "n/a"


def test_all_lists_jaxs_cells():
    """JAX's `main --all`: every arch but the encoder, at its shapes."""
    from repro.configs import list_archs, shapes_for
    want = [(a, s.name) for a in list_archs()
            if jget_config(a).family != "encoder"
            for s in shapes_for(jget_config(a))]
    assert dryrun.all_cells() == want
    assert dryrun.default_microbatches(256, 16) == 8
    assert dryrun.default_microbatches(256, 32) == 4
