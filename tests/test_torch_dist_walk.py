"""The data-sharded calibration walk: `quantize_model(mesh=)` on 2 gloo
ranks (data 2) against the port's meshless walk and JAX's, on qwen2-7b
and granite-moe-3b-a800m smoke at f32 compute (the same params from the
JAX init, the same tokens). JAX's gates (tests/test_dist.py): per-leaf
code agreement > 0.99 and Σ err_after within 2%; the MoE layers' kept
(token, slot) sets equal the meshless walk's exactly (global routing);
`dist.bytes_all_reduced` equals JAX's count for the same walk."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_worker import spawn

torch.set_num_threads(2)

ARCHS = ("qwen2-7b", "granite-moe-3b-a800m")
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
            order="greedy")
METHOD = "comq_blocked"
# f32 compute, so that the port's taps agree with JAX's to rounding; a
# capacity factor of 0.75 (1.25 in the config) makes capacity bind, so
# global routing decides which pairs drop
CFG = {"qwen2-7b": {"compute_dtype": "float32"},
       "granite-moe-3b-a800m": {"compute_dtype": "float32",
                                "capacity_factor": 0.75}}
AGREE = 0.99          # JAX's per-leaf code agreement gate
ERR_REL = 0.02        # JAX's Σ err_after gate


def _jax_codes(qparams):
    from repro.core.pipeline import is_qtensor
    out = {}
    for lkey, lp in qparams["__qlayers__"].items():
        for mod, leaves in lp.items():
            if not isinstance(leaves, dict) or is_qtensor(leaves):
                continue
            for leaf, qt in leaves.items():
                if is_qtensor(qt):
                    out[f"{lkey}.{mod}.{leaf}"] = np.asarray(qt["codes"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import get_smoke_config as jcfg
    from repro.core import QuantSpec as JSpec
    from repro.core import quantize_model as jquantize
    from repro.dist import data_mesh
    from repro.models import BuildPlan as JPlan
    from repro.models import init_params as jinit
    from repro.obs import MetricsRegistry as JRegistry
    archs, jax_out = {}, {}
    for i, arch in enumerate(ARCHS):
        kw = dict(CFG[arch])
        cfg = jcfg(arch)
        if "capacity_factor" in kw:
            kw["moe"] = dataclasses.replace(
                cfg.moe, capacity_factor=kw.pop("capacity_factor"))
        cfg = cfg.replace(**kw)
        params = jax.device_get(jinit(jax.random.PRNGKey(0), cfg,
                                      JPlan(remat=False)))
        tok = np.random.RandomState(10 + i).randint(
            0, cfg.vocab_size, (8, 32)).astype(np.int32)
        archs[arch] = {"params": params, "tokens": tok, "cfg": CFG[arch]}
        reg = JRegistry()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # on a one-device data mesh JAX's walk is its meshless walk,
            # and its Gram byte count (from shapes alone) is that of any
            # data axis
            qp, rep = jquantize(params, cfg, JPlan(remat=False),
                                jnp.asarray(tok), JSpec(**SPEC),
                                method=METHOD, mesh=data_mesh(),
                                metrics=reg)
        jax_out[arch] = {"codes": _jax_codes(qp),
                         "err": sum(r.err_after for r in rep.layers),
                         "bytes": reg.counter(
                             "dist.bytes_all_reduced").value}
    port = spawn("walk", {"archs": archs, "spec": SPEC, "method": METHOD,
                          "mesh": (2, 1)}, 2,
                 tmp_path_factory.mktemp("dist_walk"))
    return jax_out, port


def _agreement(a, b):
    return float(np.mean(a == b))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_the_same_result(runs, arch):
    _, port = runs
    a, b = port[0][(arch, "mesh")], port[1][(arch, "mesh")]
    assert a["rows"] == b["rows"]
    for k in a["codes"]:
        for f in ("codes", "z_lo", "scale"):
            np.testing.assert_array_equal(a["codes"][k][f],
                                          b["codes"][k][f])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("against", ["port", "jax"])
def test_sharded_walk_holds_jax_gates(runs, arch, against):
    jx, port = runs
    sh = port[0][(arch, "mesh")]
    if against == "port":
        ref = port[0][(arch, "single")]
        ref_codes = {k: v["codes"] for k, v in ref["codes"].items()}
        ref_err = sum(r[3] for r in ref["rows"])
    else:
        ref_codes, ref_err = jx[arch]["codes"], jx[arch]["err"]
    assert sorted(sh["codes"]) == sorted(ref_codes)
    worst = min(_agreement(sh["codes"][k]["codes"], ref_codes[k])
                for k in ref_codes)
    err = sum(r[3] for r in sh["rows"])
    print(f"{arch} vs {against}: worst leaf agreement {worst:.6f}, "
          f"err_after {err:.6f} vs {ref_err:.6f}")
    assert worst > AGREE, worst
    assert abs(err - ref_err) / ref_err < ERR_REL, (err, ref_err)
    assert sh["guard_events"] == 0


def test_moe_kept_set_is_the_replicated_walks(runs):
    """Every MoE routing call of the sharded walk, its two ranks' kept
    masks side by side in token order, equals the meshless walk's."""
    _, port = runs
    arch = "granite-moe-3b-a800m"
    single = port[0][(arch, "single")]["kept"]
    r0, r1 = port[0][(arch, "mesh")]["kept"], port[1][(arch, "mesh")]["kept"]
    assert len(single) == len(r0) == len(r1) > 0
    dropped = 0
    for want, a, b in zip(single, r0, r1):
        got = np.concatenate([a, b])
        np.testing.assert_array_equal(got, want)
        dropped += int((~want).sum())
    print(f"{len(single)} routing calls, {dropped} (token, slot) pairs "
          "dropped by capacity in the replicated walk")
    assert dropped > 0          # capacity binds: the check has teeth


@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_all_reduced_is_jax_count(runs, arch):
    jx, port = runs
    for r in port:
        assert r[(arch, "mesh")]["bytes"] == jx[arch]["bytes"] > 0
    assert port[0][(arch, "single")]["bytes"] == 0
