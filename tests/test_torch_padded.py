"""Tensor-parallel padding (`BuildPlan(tp=k)`) against the JAX package:
both packages run JAX's init at the same padded plan, converted through
numpy. At f32: forward logits (rtol = atol = 1e-4, as
tests/test_torch_model.py), lm_loss (1e-5) and its gradient (2e-4 of each
leaf's max |g|, as tests/test_torch_train.py), prefill + teacher-forced
dense decode, and for the families the paged runtime serves (qwen,
granite) a paged decode step at kv_bits 0 / 8 / 4, where JAX gathers the
pages (its XLA path; the port runs the kernels' plain versions with the
head map). The plans:

* hymba smoke at tp = 5: 4 heads pad to 5 over 2 KV heads, an uneven
  map (the padded head parked on KV head 0); at tp = 3: 6 over 2, the
  even map h // 3, which re-assigns real head 2 to KV head 0;
* qwen smoke at tp = 3 (6 over 2, even) and tp = 5 (5 over 2, uneven);
* granite smoke at tp = 3: 4 -> 6 experts (the padded ones get -1e30
  router logits), vocab 259 -> 512 (padded logit columns -1e30).

Also: the head map itself, the (kind, shape) stream of a `constrain`
callback through one forward of each package, and the plain attention
versions at an uneven map against JAX's `_dense_attention` (and at the
even map bit-identical to no map).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_smoke_config as jax_cfg
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import lm_loss as jlm_loss
from repro.models import model as jm
from repro.models.attention import _dense_attention as jdense
from repro.models.attention import head_to_kv_map as jhmap
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import headmap
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import BuildPlan, lm_loss
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from test_torch_paged import (_decode_inputs, _jax_pool, _torch_pool,
                              assert_codes_match, assert_scales_match)

torch.set_num_threads(2)

CASES = [("hymba-1.5b", 5), ("hymba-1.5b", 3), ("qwen2-7b", 3),
         ("qwen2-7b", 5), ("granite-moe-3b-a800m", 3)]
PAGED = [c for c in CASES if c[0] != "hymba-1.5b"]


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().numpy()


def _cfgs(arch):
    return (jax_cfg(arch).replace(compute_dtype="float32"),
            get_smoke_config(arch).replace(compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jparams(arch, tp):
    return jax.device_get(jax_init(jax.random.PRNGKey(0), _cfgs(arch)[0],
                                   JPlan(tp=tp, remat=False)))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-4,
                               atol=1e-4, err_msg=what)


@pytest.mark.parametrize("n,hp,kv", [(25, 32, 5), (28, 30, 4), (28, 32, 4),
                                     (4, 5, 2), (4, 6, 2), (24, 32, 8),
                                     (25, 25, 5)])
def test_head_map_is_jaxs(n, hp, kv):
    """JAX's rule, and the host tuple the dispatch takes (None: even)."""
    want = np.asarray(jhmap(n, hp, kv))
    np.testing.assert_array_equal(tattn.head_to_kv_map(n, hp, kv).numpy(),
                                  want)
    km = tattn.kernel_head_map(n, hp, kv)
    if hp % kv == 0:
        assert km is None
    else:
        assert km == tuple(int(g) for g in want)
        sizes = headmap.group_sizes(km, hp, kv)
        assert sum(sizes) == hp and max(sizes) == sizes[0]


def test_plan_padding_rules():
    plan = BuildPlan(tp=16)
    from repro_torch.configs import get_config
    for arch, hp, ep, vp in (("qwen2-7b", 32, 0, 152064),
                             ("hymba-1.5b", 32, 0, 32256),
                             ("granite-moe-3b-a800m", 32, 48, 49408)):
        cfg = get_config(arch)
        jplan = JPlan(tp=16)
        assert plan.heads_padded(cfg) == jplan.heads_padded(cfg) == hp
        assert plan.experts_padded(cfg) == jplan.experts_padded(cfg) == ep
        assert plan.vocab_padded(cfg) == jplan.vocab_padded(cfg) == vp
        assert BuildPlan().vocab_padded(cfg) == cfg.vocab_size


@pytest.mark.parametrize("arch,tp", CASES)
def test_padded_forward_loss_and_grads_match_jax(arch, tp):
    jc, tc = _cfgs(arch)
    jp = _jparams(arch, tp)
    jplan, tplan = JPlan(tp=tp, remat=False), BuildPlan(tp=tp)
    tok = _tokens(1, (2, 24), jc.vocab_size)
    tp_ = params_from_numpy(jp, "cpu")
    jl = np.asarray(jm.forward(jp, jc, jplan, jnp.asarray(tok))[0])
    with torch.no_grad():
        tl = tm.forward(tp_, tc, tplan, T(tok).long())[0]
    assert tl.shape[-1] == tplan.vocab_padded(tc) == jl.shape[-1]
    _close(N(tl), jl, f"{arch} tp={tp} logits")
    if tl.shape[-1] > tc.vocab_size:
        assert (N(tl)[..., tc.vocab_size:] == -1e30).all()

    batch = {"tokens": tok, "labels": _tokens(2, (2, 24), jc.vocab_size)}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jc, jplan,
                           {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, jp))
    leaves = [t.requires_grad_(True) for t in pytree.tree_leaves(tp_)]
    loss, _ = lm_loss(tp_, tc, BuildPlan(tp=tp, remat=False),
                      {k: T(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    want = pytree.tree_leaves(params_from_numpy(jax.device_get(jg), "cpu"))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        top = float(w.abs().max())
        assert (g - w).abs().max().item() <= 2e-4 * top + 1e-12, (arch, tp)


@pytest.mark.parametrize("arch,tp", CASES)
def test_padded_prefill_and_dense_decode_match_jax(arch, tp):
    jc, tc = _cfgs(arch)
    jp = _jparams(arch, tp)
    prompt, steps = _tokens(3, (2, 12), jc.vocab_size), 4
    jplan = JPlan(tp=tp, remat=False, cache_dtype=jnp.float32,
                  prefill_cache_len=12 + steps)
    tplan = BuildPlan(tp=tp, cache_dtype=torch.float32,
                      prefill_cache_len=12 + steps)
    tp_ = params_from_numpy(jp, "cpu")
    jlog, jcache = jm.prefill(jp, jc, jplan, jnp.asarray(prompt))
    with torch.no_grad():
        tlog, tcache = tm.prefill(tp_, tc, tplan, T(prompt).long())
    _close(N(tlog), jlog, "prefill")
    feed = _tokens(4, (2, steps), jc.vocab_size)
    for s in range(steps):
        pos = 12 + s
        jlog, jcache = jm.decode_step(jp, jc, jplan, jcache,
                                      jnp.asarray(feed[:, s:s + 1]),
                                      jnp.int32(pos))
        with torch.no_grad():
            tlog, tcache = tm.decode_step(tp_, tc, tplan, tcache,
                                          T(feed[:, s:s + 1]).long(), pos)
        _close(N(tlog), jlog, f"decode step {s}")


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("arch,tp", PAGED)
def test_padded_paged_decode_matches_jax(arch, tp, kv_bits):
    jc, tc = _cfgs(arch)
    jp = _jparams(arch, tp)
    pool, bt, pos, tokens = _decode_inputs(tc, kv_bits)
    jplan = JPlan(tp=tp, remat=False, cache_dtype=jnp.float32,
                  kv_bits=kv_bits)
    tplan = BuildPlan(tp=tp, cache_dtype=torch.float32, kv_bits=kv_bits)
    jl, jpool = jm.decode_step_paged(jp, jc, jplan, _jax_pool(pool),
                                     jnp.asarray(bt), jnp.asarray(tokens),
                                     jnp.asarray(pos))
    with torch.no_grad():
        tl, tpool = tm.decode_step_paged(params_from_numpy(jp, "cpu"), tc,
                                         tplan, _torch_pool(pool), T(bt),
                                         T(tokens).long(), T(pos))
    act = pos >= 0
    _close(N(tl)[act], np.asarray(jl)[act], f"{arch} tp={tp} paged")
    for name in jpool:
        got = tpool[name].numpy()
        if name.endswith("scale"):
            assert_scales_match(got, jpool[name], name)
        elif kv_bits:
            assert_codes_match(got, jpool[name], kv_bits, name)
        else:
            _close(got, jpool[name], name)


def _recorder(stream):
    def constrain(x, kind):
        t = x.k if kind == "kv_cache" else x
        stream.append((kind, tuple(int(d) for d in t.shape)))
        return x
    return constrain


@pytest.mark.parametrize("arch,tp", [("qwen2-7b", 3), ("hymba-1.5b", 5),
                                     ("granite-moe-3b-a800m", 3)])
def test_constrain_sites_match_jax(arch, tp):
    """The (kind, shape) stream of a constrain callback through one
    prefill of each package: JAX traces its scanned layer body once, the
    port calls it once a layer, so the port's stream is JAX's with the
    layer section repeated n_layers times."""
    jc, tc = _cfgs(arch)
    jp = _jparams(arch, tp)
    js, ts = [], []
    tok = _tokens(5, (2, 8), jc.vocab_size)
    jm.forward(jp, jc, JPlan(tp=tp, remat=False, constrain=_recorder(js)),
               jnp.asarray(tok), make_cache=True)
    with torch.no_grad():
        tm.forward(params_from_numpy(jp, "cpu"), tc,
                   BuildPlan(tp=tp, constrain=_recorder(ts)),
                   T(tok).long(), make_cache=True)
    kinds = [k for k, _ in js]
    assert kinds[0] == "residual" and kinds[-1] == "logits"
    assert {"block_in", "kv_cache"} <= set(kinds)
    assert ts == js[:1] + js[1:-1] * tc.n_layers + js[-1:]


# ---------------------------------------------------------------------------
# the plain attention versions with a head map
# ---------------------------------------------------------------------------

def _qkv(B, Tq, Tk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Tk, KV, hd)).astype(np.float32))


MAPS = [(4, 5, 2), (25, 32, 5), (28, 30, 4)]      # (n_heads, Hp, KV)


@pytest.mark.parametrize("n,hp,kv", MAPS)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_flash_plain_with_a_head_map_matches_jax(n, hp, kv, causal, window):
    hmap = tattn.kernel_head_map(n, hp, kv)
    q, k, v = _qkv(2, 12, 12, hp, kv, 16, seed=hp)
    want = np.asarray(jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jhmap(n, hp, kv), causal=causal, window=window))
    got = fa.flash_attention_plain(T(q), T(k), T(v), causal=causal,
                                   window=window, head_map=hmap)
    _close(N(got), want, "flash plain")
    # the LSE: logsumexp of the expanded scaled scores
    ke = k[:, :, list(hmap)]
    s = np.einsum("bthk,bshk->bhts", q, ke) / np.sqrt(16.0)
    mask = np.asarray(fa.attention_mask(12, 12, causal, window, "cpu"))
    s = np.where(mask, s, -np.inf)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    _close(N(fa.attention_lse_plain(T(q), T(k), causal=causal,
                                    window=window, head_map=hmap)), lse,
           "lse")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_even_map_is_bit_identical(causal):
    q, k, v = _qkv(2, 9, 9, 6, 2, 16, seed=0)
    even = headmap.even_map(6, 2)
    for fn, args in ((fa.flash_attention_plain, (T(q), T(k), T(v))),
                     (fa.attention_lse_plain, (T(q), T(k)))):
        assert torch.equal(fn(*args, causal=causal, head_map=even),
                           fn(*args, causal=causal))


@pytest.mark.parametrize("n,hp,kv", MAPS)
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_paged_plain_with_a_head_map_matches_jax(n, hp, kv, kv_bits):
    """Both paged plain versions at an uneven map against JAX's gather
    path (`paged_decode_attend[_quant]` in XLA mode, `_dense_attention`
    over the gathered pages)."""
    from repro.models.attention import paged_decode_attend as jattend
    from repro.models.attention import paged_decode_attend_quant as jattq
    from repro.serve import kv_cache as jkv
    hmap = tattn.kernel_head_map(n, hp, kv)
    rng = np.random.default_rng(hp + kv_bits)
    B, hd, NB, BS, MAXB = 3, 16, 10, 4, 5
    q = rng.standard_normal((B, hp, hd)).astype(np.float32)
    pools = [rng.standard_normal((NB, BS, kv, hd)).astype(np.float32)
             for _ in range(2)]
    bt = rng.permutation(NB)[:B * 3].reshape(B, 3)
    bt = np.concatenate([bt, bt[:, :2]], 1)[:, :MAXB].astype(np.int32)
    lens = np.asarray([11, 4, 0], np.int32)
    jmap = jhmap(n, hp, kv)
    if kv_bits == 0:
        want = jattend(jnp.asarray(q)[:, None], *map(jnp.asarray, pools),
                       jnp.asarray(bt), jnp.asarray(lens), jmap,
                       mode="xla")[:, 0]
        got = pa.paged_attention_plain(T(q), *map(T, pools), T(bt), T(lens),
                                       head_map=hmap)
    else:
        codes, scales = [], []
        for p in pools:
            s = jkv.kv_scale_of(jnp.max(jnp.abs(p), axis=(1, 3)), kv_bits)
            codes.append(np.asarray(jkv.kv_encode(jnp.asarray(p),
                                                  s[:, None], kv_bits)))
            scales.append(np.asarray(s))
        want = jattq(jnp.asarray(q)[:, None], *map(jnp.asarray, codes),
                     *map(jnp.asarray, scales), jnp.asarray(bt),
                     jnp.asarray(lens), jmap, kv_bits=kv_bits,
                     mode="xla")[:, 0]
        got = pa.paged_attention_quant_plain(
            T(q), *map(T, codes), *map(T, scales), T(bt), T(lens),
            kv_bits=kv_bits, head_map=hmap)
    # the zero-length slot: exact zeros in the port, garbage that the
    # runtime ignores in JAX's gather path
    _close(N(got)[:2], np.asarray(want)[:2], "paged plain")
    assert (N(got)[2] == 0).all()


def test_paged_plain_even_map_is_bit_identical():
    rng = np.random.default_rng(0)
    q = T(rng.standard_normal((2, 6, 16)).astype(np.float32))
    k, v = (T(rng.standard_normal((6, 4, 2, 16)).astype(np.float32))
            for _ in range(2))
    bt = T(np.arange(6, dtype=np.int32).reshape(2, 3))
    lens = T(np.asarray([9, 5], np.int32))
    assert torch.equal(
        pa.paged_attention_plain(q, k, v, bt, lens,
                                 head_map=headmap.even_map(6, 2)),
        pa.paged_attention_plain(q, k, v, bt, lens))


def test_padded_fake_quantized_tree_converts():
    """A fake-quantized padded JAX tree (QT leaves, stacked layers) carries
    across: the port's QT leaves hold JAX's codes layer by layer, and
    both forwards agree (each dequantizes a layer at a time)."""
    from repro.core.apply import fake_quantize_params as jfq
    from repro_torch.core.apply import is_qt
    jc, tc = _cfgs("granite-moe-3b-a800m")
    jplan = JPlan(tp=3, remat=False)
    jq = jax.device_get(jax.jit(lambda p: jfq(p, jc, jplan, bits=4))(
        jax.tree_util.tree_map(jnp.asarray,
                               _jparams("granite-moe-3b-a800m", 3))))
    tq = params_from_numpy(jq, "cpu")
    for layer, lp in enumerate(tq["layers"]):
        for mod, name in (("attn", "wq"), ("moe", "w_gate"),
                          ("moe", "w_down")):
            got, want = lp[mod][name], jq["layers"][mod][name]
            assert is_qt(got) and got.shape == tuple(want.shape)[1:]
            np.testing.assert_array_equal(got.codes.numpy(),
                                          want.codes[layer])
            np.testing.assert_array_equal(got.scale.numpy(),
                                          want.scale[layer])
    assert is_qt(tq["embed"])
    tok = _tokens(6, (2, 16), jc.vocab_size)
    jl = np.asarray(jm.forward(jq, jc, jplan, jnp.asarray(tok))[0])
    with torch.no_grad():
        tl = tm.forward(tq, tc, BuildPlan(tp=3), T(tok).long())[0]
    _close(N(tl), jl, "fake-quantized logits")


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_padded_train_state_round_trips(moments):
    """A padded JAX train state (f32 or int8 moments) converts to the
    port's and back, array for array."""
    from repro.configs.base import RunConfig as JRunConfig
    from repro.optim import AdamWConfig as JAdamW
    from repro.train.train_step import init_train_state as jinit
    from repro_torch.convert import (train_state_from_numpy,
                                     train_state_to_numpy)
    jp = _jparams("hymba-1.5b", 5)
    js = jax.device_get(jax.jit(lambda p: jinit(
        p, JAdamW(moment_dtype=moments), JRunConfig(arch="x")))(
            jax.tree_util.tree_map(jnp.asarray, jp)))
    back = train_state_to_numpy(train_state_from_numpy(js, "cpu"))
    want = jax.tree_util.tree_leaves_with_path(js)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    assert js["params"]["layers"]["attn"]["wq"].shape[2] == 5
