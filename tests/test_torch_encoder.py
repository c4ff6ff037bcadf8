"""The port's encoder (vit-base-16 smoke: 2 layers, d 64, 4/4 heads of
16, layernorm, a plain GELU MLP, 16 classes; patch embeddings in, a
mean-pooled class head out) against the JAX package, on the JAX init
converted through numpy with embeddings and labels from a numpy seed:
logits and loss, the 4-bit fake-quantized forward, the parameter count;
and the non-causal attention every encoder layer (and the VLM's cross
layers) runs — the plain flash version against JAX's `_dense_attention`
and the Pallas kernel in interpret mode, with Tq != Tk and ragged Tk."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_cfg
from repro.core.apply import fake_quantize_params as jax_fake_quantize
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.apply import fake_quantize_params
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import BuildPlan
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from test_torch_model import assert_close

torch.set_num_threads(2)

ARCH = "vit-base-16"
T_TOKENS = 197          # 196 patches + cls, as the JAX input_specs give


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(ARCH),
                                   JPlan(remat=False)))


def _batch(seed, B=2, T=T_TOKENS):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((B, T, jax_cfg(ARCH).d_model)).astype(
        np.float32)
    labels = rng.integers(0, jax_cfg(ARCH).vocab_size, (B,)).astype(np.int32)
    return embeds, labels


def _cfgs(cd):
    return (jax_cfg(ARCH).replace(compute_dtype=cd),
            get_smoke_config(ARCH).replace(compute_dtype=cd))


def test_config_family_and_param_count(jparams):
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.act, cfg.norm_type, cfg.causal) == (
        "encoder", 12, 768, 12, 12, 64, 3072, 1000, "gelu_mlp", "layernorm",
        False)
    tt.check_ported(cfg)
    for change in (dict(causal=True), dict(norm_type="rmsnorm")):
        with pytest.raises(NotImplementedError, match="not a configuration"):
            tt.check_ported(cfg.replace(**change))
    with pytest.raises(NotImplementedError, match="paged decode"):
        tt.check_paged(cfg)
    from repro.models.model import count_params
    assert tm.param_count(cfg) == count_params(jax_full(ARCH))
    small = get_smoke_config(ARCH)
    p = tm.init_params(small, seed=0, device="cpu")
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert tm.param_count(small) == n == count_params(jax_cfg(ARCH))
    assert sorted(p) == sorted(jparams) == ["cls_head", "final_norm",
                                            "layers", "pos_embed"]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_logits_and_loss_match_jax(jparams, cd):
    """f32 within 1e-4; bf16 under the dense test's bound."""
    jc, tc = _cfgs(cd)
    embeds, labels = _batch(1)
    jl = np.asarray(jm.forward(jparams, jc, JPlan(remat=False), None,
                               embeds=jnp.asarray(embeds))[0])
    jloss = float(jm.lm_loss(jparams, jc, JPlan(remat=False),
                             {"embeds": jnp.asarray(embeds),
                              "labels": jnp.asarray(labels)})[0])
    tp = params_from_numpy(jparams, "cpu")
    with torch.no_grad():
        tl, aux, cache = tm.forward(tp, tc, BuildPlan(), None,
                                    embeds=torch.from_numpy(embeds))
        tloss = float(tm.lm_loss(tp, tc, BuildPlan(),
                                 {"embeds": torch.from_numpy(embeds),
                                  "labels": torch.from_numpy(labels)})[0])
    assert tl.dtype == torch.float32 and tl.shape == (2, 16) and cache is None
    assert_close(tl.numpy(), jl, cd, "logits")
    assert_close(np.float32(tloss), np.float32(jloss), cd, "loss")


def test_fake_quantized_forward_matches_jax(jparams):
    """The 4-bit fake-quantized encoder (RTN codes, per channel): the same
    leaves wrapped as JAX wraps them, and the forward within 1e-4 at f32,
    every leaf dequantized a layer at a time as JAX's forward does."""
    from repro_torch.core.apply import is_qt
    jc, tc = _cfgs("float32")
    embeds, _ = _batch(2)
    jq = jax_fake_quantize(jax.tree_util.tree_map(jnp.asarray, jparams), jc,
                           JPlan(remat=False), bits=4)
    tq = fake_quantize_params(params_from_numpy(jparams, "cpu"), tc,
                              BuildPlan(), bits=4)
    lp = tq["layers"][1]
    assert all(is_qt(lp[m][k]) for m, k in (("attn", "wq"), ("attn", "wo"),
                                            ("mlp", "w_up"),
                                            ("mlp", "w_down")))
    assert not is_qt(tq["cls_head"]) and not is_qt(tq["pos_embed"])
    np.testing.assert_array_equal(
        lp["mlp"]["w_down"].codes.numpy(),
        np.asarray(jq["layers"]["mlp"]["w_down"].codes)[1])
    jl = np.asarray(jm.forward(jq, jc, JPlan(remat=False), None,
                               embeds=jnp.asarray(embeds))[0])
    with torch.no_grad():
        tl = tm.forward(tq, tc, BuildPlan(), None,
                        embeds=torch.from_numpy(embeds))[0]
    assert_close(tl.numpy(), jl, "float32", "fake-quantized logits")
    dense = np.asarray(jm.forward(jparams, jc, JPlan(remat=False), None,
                                  embeds=jnp.asarray(embeds))[0])
    assert np.abs(dense - jl).max() > 1e-3      # the codes do reach it


def test_quantize_refuses_the_encoder_as_jax_has_no_walk(capsys):
    from repro_torch.core import QuantSpec, quantize_model
    from repro_torch.launch import quantize as launch_quantize
    cfg = get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="no encoder walk"):
        quantize_model(tm.init_params(cfg, device="cpu"), cfg, BuildPlan(),
                       torch.zeros(2, 8, dtype=torch.long), QuantSpec())
    with pytest.raises(SystemExit) as e:
        launch_quantize.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert e.value.code == 2
    assert "no encoder walk" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the non-causal attention (encoder layers, VLM cross layers)
# ---------------------------------------------------------------------------

NONCAUSAL = [  # (B, Tq, Tk, H, KV, hd)
    (2, 197, 197, 4, 4, 16),      # the encoder's T, group 1
    (2, 12, 17, 4, 2, 16),        # VLM smoke cross: Tq != Tk, group 2
    (3, 1, 33, 8, 1, 32),         # a decode step over a ragged Tk, group 8
    (1, 40, 65, 2, 2, 64),        # Tk one past a 64-key tile
]


def _qkv(case, seed):
    B, Tq, Tk, H, KV, hd = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("case", NONCAUSAL)
def test_plain_noncausal_flash_matches_jax_dense_and_pallas(case):
    """f32 within 1e-5 of JAX's `_dense_attention` (what the JAX encoder
    and cross layers run) and of the Pallas kernel in interpret mode."""
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models.attention import _dense_attention, head_to_kv_map
    B, Tq, Tk, H, KV, hd = case
    q, k, v = _qkv(case, sum(case))
    got = tflash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                       causal=False).numpy()
    dense = np.asarray(_dense_attention(
        *map(jnp.asarray, (q, k, v)), head_to_kv_map(H, H, KV),
        causal=False, window=0))
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)

    def heads_first(a):        # (B, T, n, hd) -> (B·n, T, hd)
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(
            -1, a.shape[1], hd)
    pal = flash_attention_pallas(heads_first(q), heads_first(k),
                                 heads_first(v), causal=False, bq=64, bk=64,
                                 interpret=True)
    pal = np.asarray(pal).reshape(B, H, Tq, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_attention_sends_noncausal_calls_to_the_flash_dispatch(
        monkeypatch, dtype):
    """`models.attention.flash_attention(causal=False)` reaches
    `kernels.ops.flash_attention` (the CUDA kernel on a card, its plain
    version here), never `_dense_attention`; an uneven head map goes to
    it too, and three heads over two with no map raise."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    calls = []
    real = ops.flash_attention

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)
    monkeypatch.setattr(ops, "flash_attention", spy)
    monkeypatch.setattr(attn, "_dense_attention", None)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _qkv(NONCAUSAL[1], 3))
    out = attn.flash_attention(q, k, v, attn.head_to_kv_map(4, 4, 2),
                               causal=False, window=7)
    assert [(c["causal"], c["window"]) for c in calls] == [(False, 0)]
    assert out.dtype == q.dtype and out.shape == q.shape
    q3 = q[:, :, :3]
    out3 = attn.flash_attention(q3, k, v, (0, 1, 0), causal=False)
    assert calls[-1]["head_map"] == (0, 1, 0)
    assert torch.equal(out3, real(q3, k, v, causal=False,
                                  head_map=(0, 1, 0)))
    with pytest.raises(ValueError, match="need a head map"):
        attn.flash_attention(q3, k, v, None, causal=False)
