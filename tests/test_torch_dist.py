"""repro_torch.dist against repro.dist: the Gram all-reduce, the column-
sharded solve (dense, padded, shared-greedy, the fused shared-tap group
and a 4/8/2-bit group) and the compressed all-reduce, on the same seeded
numpy inputs. The JAX side runs in one subprocess with 8 forced host
devices (conftest forbids the flag in-process): data axis of 4, the
(2, 4) calibration mesh. The port side runs in gloo worlds of 4 ranks
(`tests/torch_dist_worker.py`). Plus the pieces that need no world: the
column partition, the paged layout, the run digest's mesh term, and a
world of one in this process."""
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_dist_worker import spawn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
GRAM_RTOL = 1e-5          # relative to max|H|: summation order only
SCALE_RTOL = 2e-6         # the per-shard reductions move scales <= 2 ulp


def _gram_of(x):
    return (x.T @ x).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    solves = []
    for m, n, order in ((96, 192, "cyclic"), (96, 100, "cyclic"),
                        (64, 90, "greedy_shared")):
        solves.append({
            "h": _gram_of(rs.randn(2 * m, m).astype(np.float32)),
            "w": (rs.randn(m, n) * 0.05).astype(np.float32),
            "spec": dict(bits=4, granularity="per_channel", lam=0.9,
                         sweeps=3, order=order), "block": 32})
    m = 96
    group = {"h": _gram_of(rs.randn(2 * m, m).astype(np.float32)),
             "ws": [(rs.randn(m, 64 + 13 * i) * 0.05).astype(np.float32)
                    for i in range(3)],                 # 64, 77, 90 cols
             "spec": dict(bits=4, granularity="per_channel", lam=0.9,
                          sweeps=2, order="cyclic"),
             "mixed_bits": [4, 8, 2]}
    return {"tap": rs.randn(8, 16, 32).astype(np.float32),
            "etap": rs.randn(3, 8, 16).astype(np.float32),
            "odd_tap": rs.randn(5, 4, 8).astype(np.float32),
            "odd_etap": rs.randn(2, 5, 8).astype(np.float32),
            "g": {"a": np.linspace(-1.0, 1.0, 16, dtype=np.float32
                                   ).reshape(4, 4),
                  "b": np.full((4, 2), 0.123, np.float32)},
            "solves": solves, "group": group}


_JAX_SCRIPT = r"""
import os, pickle, sys, functools, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core import QuantSpec
from repro.core.comq_hessian import comq_quantize_blocked
from repro.core.pipeline import _solve_group
from repro.dist import (calib_mesh, compressed_psum, data_mesh,
                        init_error_state, sharded_batched_gram, sharded_gram,
                        sharded_solve)
assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
g = lambda a: np.asarray(jax.device_get(a))
out = {}
dm = data_mesh(4)
out["gram"] = g(sharded_gram(dm, jnp.asarray(inp["tap"])))
out["bgram"] = g(sharded_batched_gram(dm, jnp.asarray(inp["etap"])))
gt = {k: jnp.asarray(v) for k, v in inp["g"].items()}
def two(gg, ee):
    o1, e1 = compressed_psum(gg, "data", ee, 4)
    o2, e2 = compressed_psum(gg, "data", e1, 4)
    return o1, e1, o2, e2
res = shard_map(two, mesh=dm, in_specs=(P("data"), P("data")),
                out_specs=(P("data"),) * 4)(gt, init_error_state(gt))
out["compressed"] = jax.tree_util.tree_map(g, res)
mesh = calib_mesh(model=4)
assert dict(mesh.shape) == {"data": 2, "model": 4}
out["solves"], out["replicated"] = [], []
for c in inp["solves"]:
    spec = QuantSpec(**c["spec"])
    h, w = jnp.asarray(c["h"]), jnp.asarray(c["w"])
    out["solves"].append([g(a) for a in sharded_solve(
        mesh, h, w, spec, "comq_blocked", block=c["block"])])
    r = comq_quantize_blocked(h, w, spec, block=c["block"])
    out["replicated"].append([g(r.q), g(r.delta), g(r.z_lo), g(r.errors)])
grp = inp["group"]
h = jnp.asarray(grp["h"])
ws = [jnp.asarray(w) for w in grp["ws"]]
solve_sh = functools.partial(sharded_solve, mesh, method="comq_blocked")
for key, bits in (("fused", [grp["spec"]["bits"]] * len(ws)),
                  ("mixed", grp["mixed_bits"])):
    specs = [QuantSpec(**{**grp["spec"], "bits": b}) for b in bits]
    res = _solve_group(ws, h, specs, "comq_blocked", solve_sh=solve_sh)
    out[key] = [{"codes": g(qt["codes"]), "z_lo": g(qt["z_lo"]),
                 "scale": g(qt["scale"]), "bits": qt["bits"],
                 "err_after": float(ea)} for qt, _, ea, _ in res]
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX_DIST_OK")
"""


@pytest.fixture(scope="module")
def both(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_prims")
    inp = work / "jax.in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(inp),
                             str(work / "jax.out.pkl")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    port = spawn("prims", inputs, 4, work)      # meanwhile, the port's world
    so, se = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "JAX_DIST_OK" in so, se[-3000:]
    with open(work / "jax.out.pkl", "rb") as f:
        jx = pickle.load(f)
    return jx, port


def test_meshes_are_jax_shaped(both):
    _, port = both
    for r in port:
        assert r["data_mesh"] == {"data": 4}
        assert r["solve_mesh"] == {"data": 1, "model": 4}


@pytest.mark.parametrize("key", ["gram", "bgram"])
def test_gram_all_reduce_matches_jax(both, key):
    """One all-reduce of the local Grams over 4 data ranks == JAX's psum
    over 4 shards, on every rank."""
    jx, port = both
    want = jx[key]
    for r in port:
        err = np.max(np.abs(r[key] - want)) / np.max(np.abs(want))
        assert err <= GRAM_RTOL, (key, err)


def test_indivisible_taps_warn_and_fall_back(both, inputs):
    _, port = both
    x = inputs["odd_tap"].reshape(-1, 8)
    e = inputs["odd_etap"]
    for r in port:
        assert any("falling back" in w for w in r["warnings"])
        assert any("moe_capacity_multiple" in w for w in r["warnings"])
        np.testing.assert_allclose(r["odd_gram"], x.T @ x, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["odd_bgram"],
                                   np.einsum("ecd,ecf->edf", e, e),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["96x192", "96x100-padded", "greedy_shared"])
def test_sharded_solve_is_jax_bit_for_bit(both, case):
    """model 4: the port's codes and zero-points equal JAX's forced (2, 4)
    mesh's and the port's replicated solve's bit for bit; scales to f32
    rounding; the per-column errors add up to the solver's error."""
    jx, port = both
    jq, jd, jz = jx["solves"][case][:3]
    for r in port:
        q, d, z, _, e2a = r["solves"][case]
        rq, rd_, rz, rerr = r["replicated"][case]
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(z, jz)
        np.testing.assert_array_equal(q, rq)
        np.testing.assert_array_equal(z, rz)
        np.testing.assert_allclose(d, jd, rtol=SCALE_RTOL)
        np.testing.assert_allclose(d, rd_, rtol=SCALE_RTOL)
        np.testing.assert_allclose(np.sqrt(max(float(e2a.sum()), 0.0)),
                                   float(rerr[-1]), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("key", ["fused", "mixed"])
def test_sharded_group_is_jax_bit_for_bit(both, key):
    """`_solve_group(solve_sh=...)`: the fused shared tap (3 ragged leaves)
    and a 4/8/2-bit group give JAX's sharded QTensors and the port's
    replicated ones."""
    jx, port = both
    for r in port:
        for jq, sq, rq in zip(jx[key], r[f"{key}_sharded"],
                              r[f"{key}_replicated"]):
            assert sq["bits"] == jq["bits"] == rq["bits"]
            np.testing.assert_array_equal(sq["codes"], jq["codes"])
            np.testing.assert_array_equal(sq["z_lo"], jq["z_lo"])
            np.testing.assert_array_equal(sq["codes"], rq["codes"])
            np.testing.assert_allclose(sq["scale"], jq["scale"],
                                       rtol=SCALE_RTOL)
            np.testing.assert_allclose(float(sq["err_after"]),
                                       jq["err_after"], rtol=1e-3,
                                       atol=1e-4)


def test_compressed_all_reduce_matches_jax(both):
    """Two error-feedback steps over 4 ranks: each rank's mean and carried
    residual equal JAX's shard's, to f32 rounding."""
    jx, port = both
    for rank, r in enumerate(port):
        for step in range(4):                 # out1, err1, out2, err2
            for k in ("a", "b"):
                want = jx["compressed"][step][k][rank:rank + 1]
                np.testing.assert_allclose(r["compressed"][step][k], want,
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{step} {k}")


# ---------------------------------------------------------------------------
# no world needed
# ---------------------------------------------------------------------------

def test_column_slice_pads_at_the_end():
    from repro_torch.dist import column_slice
    assert column_slice(90, 0, 4) == (0, 23, 92)
    assert column_slice(90, 3, 4) == (69, 92, 92)
    assert column_slice(18944, 1, 2) == (9472, 18944, 18944)
    with pytest.raises(ValueError):
        column_slice(8, 2, 2)


def test_paged_layout_and_jax_error():
    from repro.dist.sharding import paged_runtime_specs
    from repro_torch.dist import paged_layout
    assert paged_layout(4, 8, 16, rank=3) == {
        "blocks": 4, "slots": 2, "block_lo": 12, "slot_lo": 6}
    mesh = SimpleNamespace(shape={"model": 4})
    for slots, blocks in ((8, 18), (6, 16)):
        with pytest.raises(ValueError) as ej:
            paged_runtime_specs({}, mesh, slots, blocks)
        with pytest.raises(ValueError) as et:
            paged_layout(4, slots, blocks)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2}, {"data": 4},
                                   {"data": 1, "model": 1}])
def test_run_digest_mesh_term_is_jax(shape):
    """`_run_digest` equals JAX's for the same mesh shape (JAX's reads only
    `mesh.shape`, so a stub serves both packages)."""
    from repro.configs import get_smoke_config as jcfg
    from repro.core import QuantSpec as JSpec
    from repro.core.pipeline import _run_digest as jdigest
    from repro.core.policy import as_policy as jpolicy
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import QuantSpec
    from repro_torch.core.pipeline import _run_digest
    from repro_torch.core.policy import as_policy
    tok = np.random.RandomState(1).randint(0, 256, (4, 16)).astype(np.int32)
    mesh = SimpleNamespace(shape=shape)
    spec = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
                order="greedy")
    want = jdigest(jcfg("qwen2-7b"), jpolicy(JSpec(**spec)), "comq_blocked",
                   "staged", tok, False, mesh)
    got = _run_digest(get_smoke_config("qwen2-7b"), as_policy(
        QuantSpec(**spec)), "comq_blocked", "staged", torch.from_numpy(tok),
        False, mesh)
    assert got == want
    assert got != _run_digest(get_smoke_config("qwen2-7b"), as_policy(
        QuantSpec(**spec)), "comq_blocked", "staged", torch.from_numpy(tok),
        False, None)


@pytest.fixture
def world_of_one():
    from repro_torch import dist as rd
    dev, started = rd.init_world("gloo", "cpu")
    yield dev
    rd.close_world(started)


def test_world_of_one_mesh_is_a_real_device_mesh(world_of_one):
    """In-process world of one: the DeviceMesh's shape dict, a Gram with no
    collective (an axis of one), the digest's mesh term of a real mesh,
    the compressed identity out + new_e == g, and the refusals."""
    from repro.configs import get_smoke_config as jcfg
    from repro.core import QuantSpec as JSpec
    from repro.core.pipeline import _run_digest as jdigest
    from repro.core.policy import as_policy as jpolicy
    from repro_torch import dist as rd
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import QuantSpec
    from repro_torch.core.pipeline import _run_digest
    from repro_torch.core.policy import as_policy
    mesh = rd.calib_mesh(model=1)
    assert rd.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert rd.model_size(mesh) == 1 and rd.model_size(None) == 1
    tok = np.zeros((2, 8), np.int32)
    spec = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
                order="greedy")
    assert _run_digest(get_smoke_config("qwen2-7b"), as_policy(
        QuantSpec(**spec)), "rtn", "staged", torch.from_numpy(tok), False,
        mesh) == jdigest(jcfg("qwen2-7b"), jpolicy(JSpec(**spec)), "rtn",
                         "staged", tok, False,
                         SimpleNamespace(shape={"data": 1, "model": 1}))
    seen = []
    prev = rd.set_allreduce_observer(seen.append)
    x = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(0))
    h = rd.reduce_gram(mesh, x)
    rd.set_allreduce_observer(prev)
    assert seen == [5 * 5 * 4]
    torch.testing.assert_close(h, x.reshape(-1, 5).T @ x.reshape(-1, 5))
    assert torch.equal(rd.shard_batch(mesh, x), x)
    g = {"w": torch.linspace(-2.0, 3.0, 7), "b": torch.full((3,), 0.5)}
    out, err = rd.compressed_all_reduce(g, rd.init_error_state(g))
    for k in g:
        torch.testing.assert_close(out[k] + err[k], g[k], rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        rd.calib_mesh(model=2)
    with pytest.raises(ValueError, match="not divisible"):
        rd.shard_batch(SimpleNamespace(shape={"data": 2}),
                       torch.zeros(3, 2))


def test_smoke_mesh_is_jax_smoke_mesh(world_of_one):
    from repro.launch.mesh import make_smoke_mesh as jax_smoke
    from repro_torch.dist import mesh_shape
    from repro_torch.launch.mesh import make_smoke_mesh
    assert mesh_shape(make_smoke_mesh()) == dict(jax_smoke().shape)


def test_nccl_is_refused_where_it_cannot_run(monkeypatch):
    from repro_torch.dist.world import check_backend
    with pytest.raises(ValueError, match="gloo on the CPU"):
        check_backend("nccl", torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend("mpi", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", torch.device("cuda", 0))
