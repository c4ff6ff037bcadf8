"""The GSPMD spec layer (repro_torch.dist.sharding, core.apply's QT specs,
launch.dryrun._opt_specs) against the JAX package's, entry for entry:
param specs for every registered arch at `BuildPlan(tp=16)` (JAX's trees
from `jax.eval_shape`, the port's on the meta device) on the 16 x 16 and
2 x 16 x 16 production meshes (JAX's side on an `AbstractMesh` stand-in),
cache and input specs at each arch's shapes, QT specs of fake-quantized
trees, the train state's specs (f32, int8, int8_ef) and make_constrain's
spec for each kind; and every rank's bytes summed from both packages'
trees and specs.

The port's per-layer leaves have no leading layer-stack dims, which
JAX's param rules leave replicated, so a port param's spec is JAX's
without those leading None entries. Caches are held to JAX's
`cache_specs` applied to the per-layer leaves: JAX's rule locates the
batch dim by size, so on its stacked leaves, where the layer count
equals the global batch (granite, hymba, rwkv6 at prefill_32k: 32 and
32), it puts the batch axes on the layer dim instead. Each rank holds
the same bytes either way, which the tests check against JAX's stacked
trees and specs.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.core.apply import QT as JQT
from repro.dist import sharding as js
from repro.models import BuildPlan as JPlan
from repro.models import model as jm
from repro_torch.configs import get_config, list_archs, shapes_for
from repro_torch.core.apply import QT, is_qt, qt_param_specs
from repro_torch.dist import sharding as ts
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import BuildPlan
from repro_torch.models import model as tm

torch.set_num_threads(2)

META = torch.device("meta")
MESHES = [False, True]


def _jmesh(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _jparams(arch, dtype=None):
    cfg = jget_config(arch)
    p = jax.eval_shape(lambda k: jm.init_params(k, cfg, JPlan(tp=16)),
                       jax.random.PRNGKey(0))
    if dtype is not None:
        p = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, dtype)
            if s.dtype == jnp.float32 else s, p)
    return p


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return tm.init_params(get_config(arch), BuildPlan(tp=16), device=META)


def _unstack(jtree, lead: int):
    """A JAX spec tree of leaves stacked over `lead` leading dims, as the
    spec tree of one layer (the leading entries dropped, and checked
    None)."""
    def drop(s):
        assert all(e is None for e in tuple(s)[:lead]), s
        return tuple(s)[lead:]
    return jax.tree_util.tree_map(drop, jtree,
                                  is_leaf=lambda x: isinstance(x, JP))


def _port_layout(jspecs, cfg):
    """JAX's param spec tree in the port's layout: "layers" a per-layer
    list, a VLM's "groups" per-group lists."""
    out = {}
    for k, v in jspecs.items():
        if k == "layers":
            out[k] = [_unstack(v, 1)] * cfg.n_layers
        elif k == "groups":
            g, spg = tm.vlm_group_counts(cfg)
            out[k] = {"self": [[_unstack(v["self"], 2)] * spg] * g,
                      "cross": [_unstack(v["cross"], 1)] * g}
        else:
            out[k] = jax.tree_util.tree_map(
                tuple, v, is_leaf=lambda x: isinstance(x, JP))
    return out


def _flat(tree, prefix=""):
    """{path: leaf} over dicts (sorted), lists and NamedTuples; specs and
    tensors are leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_flat(getattr(tree, f), f"{prefix}/{f}"))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not _is_spec(tree)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {} if tree is None else {prefix: tree}


def _is_spec(t) -> bool:
    """A spec: entries None, an axis name or a tuple of names."""
    return all(e is None or isinstance(e, str)
               or (isinstance(e, tuple) and e
                   and all(isinstance(a, str) for a in e)) for e in t)


def _jax_bytes(tree, specs, mesh):
    """Σ of one rank's slice over a JAX shape tree under JAX specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(sp)
    return sum(math.prod(JNamed(mesh, s).shard_shape(l.shape))
               * np.dtype(l.dtype).itemsize for l, s in zip(leaves, sp))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax(arch, multi_pod):
    cfg = get_config(arch)
    jspecs = js.param_specs(_jparams(arch), _jmesh(multi_pod))
    mesh = make_production_mesh(multi_pod=multi_pod)
    tspecs = ts.param_specs(_tparams(arch), mesh)
    want, got = _flat(_port_layout(jspecs, cfg)), _flat(tspecs)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    assert ts.local_bytes(_tparams(arch), tspecs, mesh) == _jax_bytes(
        _jparams(arch), jspecs, _jmesh(multi_pod))


@pytest.mark.parametrize("arch,gib", [("qwen2-7b", 0.4942),
                                      ("hymba-1.5b", 0.2051),
                                      ("granite-moe-3b-a800m", 0.2542)])
def test_local_f32_param_bytes(arch, gib):
    """Σ local f32 param bytes a device at tp = 16 on 16 x 16: the
    reference figures, from both packages' trees and specs."""
    mesh = make_production_mesh()
    got = ts.local_bytes(_tparams(arch),
                         ts.param_specs(_tparams(arch), mesh), mesh)
    assert got == _jax_bytes(_jparams(arch),
                             js.param_specs(_jparams(arch), _jmesh(False)),
                             _jmesh(False))
    assert round(got / 2 ** 30, 4) == gib


# ---------------------------------------------------------------------------
# caches and inputs
# ---------------------------------------------------------------------------

def _per_layer(jcache, cfg):
    """JAX's cache shape tree with the layer-stack dims removed: each
    per-layer leaf's shape, in the port's layout (per-layer lists)."""
    def strip(v, lead):
        return jax.tree_util.tree_map(
            lambda l: jax.ShapeDtypeStruct(l.shape[lead:], l.dtype), v)
    out = {}
    for k, v in jcache.items():
        if k == "xkv":
            out[k] = v
        elif cfg.family == "vlm":
            g, spg = tm.vlm_group_counts(cfg)
            out[k] = [[strip(v, 2)] * spg] * g
        else:
            out[k] = [strip(v, 1)] * cfg.n_layers
    return out


def _cells():
    return [(a, s.name, mp) for a in list_archs()
            for s in shapes_for(get_config(a)) for mp in MESHES]


@pytest.mark.parametrize("arch,shape,multi_pod", _cells())
def test_cache_and_input_specs_match_jax(arch, shape, multi_pod):
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES
    cfg, sh = get_config(arch), SHAPES[shape]
    gb = sh.global_batch
    jmesh, mesh = _jmesh(multi_pod), make_production_mesh(
        multi_pod=multi_pod)
    assert ts.batch_dim_spec(mesh, gb) == js.batch_dim_spec(jmesh, gb)
    jin = jm.input_specs(jget_config(arch), JSHAPES[shape], JPlan(tp=16))
    tin = tm.input_specs(cfg, sh, BuildPlan(tp=16))
    jb = js.input_batch_specs({k: v for k, v in jin.items()
                               if k != "cache"}, jmesh, gb)
    tb = ts.input_batch_specs({k: v for k, v in tin.items()
                               if k != "cache"}, mesh, gb)
    assert {k: tuple(v) for k, v in tb.items()} == \
        {k: tuple(v) for k, v in jb.items()}
    for k in jb:
        assert tuple(tin[k].shape) == tuple(jin[k].shape)
    if sh.kind == "train":
        return
    jcache = jax.eval_shape(lambda: jm.init_cache(
        jget_config(arch), JPlan(tp=16), gb, sh.seq_len))
    tcache = tm.init_cache(cfg, BuildPlan(tp=16), gb, sh.seq_len,
                           device=META)
    jc = js.cache_specs(jcache, jmesh, gb)
    tc = ts.cache_specs(tcache, mesh, gb)
    # JAX's rule on the per-layer leaves (see the module docstring)
    per_layer = _per_layer(jcache, cfg)
    want = _flat(jax.tree_util.tree_map(
        tuple, js.cache_specs(per_layer, jmesh, gb),
        is_leaf=lambda x: isinstance(x, JP)))
    got = _flat(tc)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    for k, t in _flat(tcache).items():
        assert tuple(t.shape) == tuple(_flat(per_layer)[k].shape), k
    assert ts.local_bytes(tcache, tc, mesh) == _jax_bytes(jcache, jc, jmesh)


# ---------------------------------------------------------------------------
# QT leaves of fake-quantized trees
# ---------------------------------------------------------------------------

def _qt_specs_flat(tree, is_q):
    """{path: spec} of a QT-spec tree, a QT's codes / scale / z_lo under
    its path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif is_q(t):
            for f in ("codes", "scale", "z_lo"):
                out[f"{path}.{f}"] = tuple(getattr(t, f))
        elif isinstance(t, list):
            walk(t[0], path)       # every layer's spec is layer 0's
            assert all(_qt_specs_flat(x, is_q) == _qt_specs_flat(t[0], is_q)
                       for x in t)
        else:
            out[path] = tuple(t)
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-3b-a800m"])
def test_qt_param_specs_match_jax(arch):
    from repro.core.apply import fake_quantize_params as jfq
    from repro.core.apply import qt_param_specs as jqt_specs
    from repro_torch.core.apply import fake_quantize_params as tfq
    from repro_torch.launch.dryrun import _to_bf16
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmesh, mesh = _jmesh(False), make_production_mesh()
    jp = _jparams(arch, jnp.bfloat16)
    jq = jax.eval_shape(lambda p: jfq(p, jcfg, JPlan(tp=16), bits=4), jp)
    jspec = jqt_specs(jq, js.param_specs(jp, jmesh))
    tp = _to_bf16(_tparams(arch))
    tq = tfq(tp, cfg, BuildPlan(tp=16), bits=4)
    tspec = ts.param_specs(tq, mesh)
    via = qt_param_specs(tq, ts.param_specs(tp, mesh))
    assert _qt_specs_flat(tspec, is_qt) == _qt_specs_flat(via, is_qt)
    # JAX's specs without the stacked layer dims
    jflat = _qt_specs_flat(jax.tree_util.tree_map(
        lambda x: x, jspec, is_leaf=lambda x: isinstance(x, (JP, JQT))),
        lambda t: isinstance(t, JQT))
    got = _qt_specs_flat(tspec, is_qt)
    for path, spec in got.items():
        jpath = path
        want = jflat[jpath]
        lead = len(want) - len(spec)
        assert all(e is None for e in want[:lead]), (path, want)
        assert spec == want[lead:], (path, spec, want)
    assert set(got) == set(jflat)
    assert ts.local_bytes(tq, tspec, mesh) == sum(
        math.prod(JNamed(jmesh, s).shard_shape(l.shape))
        * np.dtype(l.dtype).itemsize for l, s in zip(
            jax.tree_util.tree_leaves(jq),
            jax.tree_util.tree_leaves(
                jspec, is_leaf=lambda x: isinstance(x, JP))))


# ---------------------------------------------------------------------------
# the train state and make_constrain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments,compression", [("float32", "none"),
                                                 ("int8", "none"),
                                                 ("int8", "int8_ef")])
def test_opt_specs_match_jax(moments, compression):
    """tests/test_train.py::test_dryrun_opt_specs_cover_int8_moment_state
    on the port, and the same specs as JAX's `_opt_specs`."""
    from repro.configs.base import RunConfig as JRunConfig
    from repro.launch.dryrun import _opt_specs as jopt_specs
    from repro.optim import AdamWConfig as JAdamW
    from repro.train.train_step import init_train_state as jinit
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.dryrun import _opt_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import init_train_state
    jparams = {"a": {"w": jnp.zeros((8, 512))}, "b": jnp.zeros((256,))}
    jps = {"a": {"w": JP(None, "data")}, "b": JP(None)}
    tparams = {"a": {"w": torch.zeros(8, 512)}, "b": torch.zeros(256)}
    tps = {"a": {"w": ts.P(None, "data")}, "b": ts.P(None)}
    jstate = jax.eval_shape(
        lambda p: jinit(p, JAdamW(moment_dtype=moments),
                        JRunConfig(arch="x", grad_compression=compression)),
        jparams)
    tstate = init_train_state(tparams, AdamWConfig(moment_dtype=moments),
                              RunConfig(arch="x",
                                        grad_compression=compression))
    want = jopt_specs(jstate, jps)
    got = _opt_specs(tstate, tps)
    tup = functools.partial(jax.tree_util.tree_map, tuple,
                            is_leaf=lambda x: isinstance(x, (JP, ts.P)))
    assert _flat(tup(got)) == _flat(tup(want))
    # every state leaf has a spec
    assert set(_flat(tstate)) == set(_flat(tup(got)))
    if moments == "int8":
        assert set(got["opt"]["m"]["a"]["w"]) == (
            {"q", "scale", "ef"} if "ef" in tstate["opt"]["m"]["a"]["w"]
            else {"q", "scale"})
        assert set(got["opt"]["v"]["a"]["w"]) == {"q", "scale"}


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("flags", [{}, {"seq_shard": True},
                                   {"seq_shard": True, "block_gather": True},
                                   {"ffn_shard": True}])
def test_make_constrain_specs_match_jax(monkeypatch, multi_pod, flags):
    """The spec each kind pins: JAX's (its with_sharding_constraint
    recorded) against the port's callback's record."""
    from repro.models.attention import init_kv_cache as jkv
    from repro_torch.models.attention import init_kv_cache as tkv
    jmesh, mesh = _jmesh(multi_pod), make_production_mesh(
        multi_pod=multi_pod)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    gb = 64
    jc = js.make_constrain(jmesh, gb, **flags)
    tc = ts.make_constrain(mesh, gb, **flags)
    cases = [("residual", (gb, 32, 48)), ("residual", (gb, 24, 48)),
             ("block_in", (gb, 32, 48)), ("logits", (gb, 32, 512)),
             ("logits", (gb, 32, 259)), ("ffn_hidden", (gb, 32, 128))]
    for kind, shape in cases:
        seen.clear()
        jc(jnp.zeros(shape, jnp.bfloat16), kind)
        x = torch.zeros(shape, dtype=torch.bfloat16, device=META)
        assert tc(x, kind) is x
        got = tc.specs[-1]
        assert got[0] == kind
        assert (tuple(got[1]) if got[1] is not None else None) == (
            seen[0] if seen else None), (kind, shape)
        assert tc.spec_of(x, kind) == got[1]
    seen.clear()
    jc(jkv(gb, 16, 4, 32), "kv_cache")
    tcache = tkv(gb, 16, 4, 32, device=META)
    tc(tcache, "kv_cache")
    assert tc.specs[-1][0] == "kv_cache"
    got = [tuple(s) for s in _flat(tc.specs[-1][1]).values()]
    assert got == seen
