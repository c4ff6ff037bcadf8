"""The port's staged quantize_model against the JAX pipeline on qwen2-7b
smoke (comq_blocked, 4-bit per-channel, greedy, calibration 2x48 as the CI
smoke runs it), the .qpk exchange with the JAX reader, and the launcher's
JSON summary."""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.quantized import load_packed_ckpt as jax_load
from repro.ckpt.quantized import unpack_tree as jax_unpack
from repro.configs import get_smoke_config as jax_cfg
from repro.core import QuantSpec as JSpec
from repro.core import quantize_model as jax_quantize
from repro.core.pipeline import dequant_qtensor as jax_dequant
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro_torch.ckpt import pack_tree, save_packed_ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.core.pipeline import dequant_qtensor, is_qtensor
from repro_torch.launch import quantize as launcher
from repro_torch.models import BuildPlan

torch.set_num_threads(2)

ARCH = "qwen2-7b"
SPEC = dict(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
            order="greedy")
# same weights and tokens; the bf16 taps differ by rounding between the
# frameworks (tests/test_torch_model.py), which moves per-leaf errors by a
# few percent
ERR_RTOL = 0.05


@pytest.fixture(scope="module")
def runs():
    jparams = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                      JPlan(remat=False)))
    tok = np.random.default_rng(0).integers(0, 256, (2, 48)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 96 calibration tokens < d_ff
        _, jrep = jax_quantize(jparams, jax_cfg(ARCH), JPlan(remat=False),
                               jnp.asarray(tok), JSpec(**SPEC),
                               method="comq_blocked", guards=False)
        tq, trep = quantize_model(params_from_numpy(jparams, "cpu"),
                                  get_smoke_config(ARCH), BuildPlan(),
                                  torch.from_numpy(tok).long(),
                                  QuantSpec(**SPEC), method="comq_blocked")
    return jrep, tq, trep


def test_per_leaf_errors_match_jax(runs):
    jrep, _, trep = runs
    assert [(r.layer, r.name) for r in trep.layers] == \
        [(r.layer, r.name) for r in jrep.layers]
    for jr, tr in zip(jrep.layers, trep.layers):
        np.testing.assert_allclose(tr.err_before, jr.err_before,
                                   rtol=ERR_RTOL, err_msg=tr.name)
        np.testing.assert_allclose(tr.err_after, jr.err_after,
                                   rtol=ERR_RTOL, err_msg=tr.name)
    print(f"improvement: port {trep.total_improvement():.4f}, "
          f"jax {jrep.total_improvement():.4f}")
    assert trep.total_improvement() >= 0.3
    assert jrep.total_improvement() >= 0.3


def test_port_qpk_loads_in_jax_and_dequantizes_exactly(runs, tmp_path):
    _, tq, _ = runs
    table = tq["__qlayers__"]
    path = str(tmp_path / "port.qpk")
    save_packed_ckpt(path, pack_tree(table), arch=ARCH, bits=4)
    loaded = jax_load(path)
    assert loaded["arch"] == ARCH and loaded["bits"] == 4
    jtable = jax_unpack(loaded["tree"])
    n = 0
    for layer, lp in table.items():
        for mod, leaves in lp.items():
            for leaf, node in leaves.items():
                jnode = jtable[layer][mod][leaf]
                if is_qtensor(node):
                    assert jnode["bits"] == 4
                    np.testing.assert_array_equal(
                        np.asarray(jax_dequant(jnode)),
                        dequant_qtensor(node).numpy())
                    n += 1
                else:
                    np.testing.assert_array_equal(np.asarray(jnode),
                                                  node.numpy())
    assert n == 14


def test_tap_gram_cache_computes_one_gram_per_tap():
    from repro_torch.core.calibrate import TapGramCache, gram_from_tap
    g = torch.Generator().manual_seed(0)
    taps = {name: torch.randn(2, 8, 6, generator=g)
            for name in ("attn_in", "mlp_in")}
    cache = TapGramCache()
    for name in ("attn_in", "attn_in", "attn_in", "mlp_in", "mlp_in"):
        h = cache.gram(name, taps[name])
        assert torch.equal(h, gram_from_tap(taps[name]))
    assert cache.computed == 2


JAX_SUMMARY_KEYS = [
    "arch", "method", "bits", "mixed_policy", "bits_budget", "propagation",
    "data_shards", "model_shards", "order", "granularity",
    "layers_quantized", "comq_vs_rtn_error_improvement", "fp_loss",
    "quant_loss", "seconds", "ckpt_bytes", "dense_bytes", "compression",
    "guard_events", "resumed_leaves", "faults_fired"]


def test_launcher_prints_the_json_summary(capsys, tmp_path):
    qpk = str(tmp_path / "smoke.qpk")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        launcher.main(["--arch", ARCH, "--smoke", "--method", "comq_blocked",
                       "--calib-batch", "2", "--calib-seq", "48",
                       "--save-packed", qpk, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == JAX_SUMMARY_KEYS
    assert out["layers_quantized"] == 14
    assert out["data_shards"] == 1 and out["model_shards"] == 1
    assert out["comq_vs_rtn_error_improvement"] > 0.3
    assert abs(out["quant_loss"] - out["fp_loss"]) < 0.15
    assert jax_load(qpk)["arch"] == "qwen2-7b-smoke"
