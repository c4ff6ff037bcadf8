"""The port's paged KV path against the JAX package on the same numpy
inputs: the plain paged-attention kernels against the JAX oracle, the
Pallas kernels in interpret mode and the JAX model's gather fallback; the
pool write paths (kv_encode/kv_decode, write_prefill, paged_insert,
paged_insert_quant); and decode_step_paged logits on qwen2 smoke, dense
and from packed codes. Each Hopper kernel is held against its plain
version on the card in tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.core import QuantSpec as JSpec
from repro.core import quantize_model as jax_quantize
from repro.core.apply import serving_params as jax_serving
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import model as jm
from repro.models.attention import head_to_kv_map as jhmap
from repro.models.attention import paged_decode_attend as jattend
from repro.models.attention import paged_decode_attend_quant as jattend_q
from repro.models.attention import paged_insert as jinsert
from repro.models.attention import paged_insert_quant as jinsert_q
from repro.serve import kv_cache as jkv
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, qparams_from_numpy
from repro_torch.core.apply import serving_params
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import BuildPlan
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv

torch.set_num_threads(2)

ARCH = "qwen2-7b"
B, KV, hd, NB, BS, MAXB = 3, 2, 16, 10, 4, 5
LENGTHS = [17, 4, 0]


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _pool_inputs(H, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    bt = rng.integers(0, NB, (B, MAXB)).astype(np.int32)
    return q, k, v, bt, np.asarray(LENGTHS, np.int32)


def _quant_pool(k, v, kv_bits):
    """Codes + (NB, KV) scales of f32 pages, made by the JAX encoder."""
    out = []
    for pool in (k, v):
        s = jkv.kv_scale_of(jnp.max(jnp.abs(pool), axis=(1, 3)), kv_bits)
        c = jkv.kv_encode(jnp.asarray(pool), s[:, None], kv_bits)
        out += [np.asarray(c), np.asarray(s)]
    return out          # kq, ks, vq, vs


# ---------------------------------------------------------------------------
# plain kernels vs the JAX oracle, Pallas interpret and the model fallback
# (tolerance atol 1e-5: the same f32 math in another summation order; the
# inactive slot must be exactly 0)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [4, 14])
@pytest.mark.parametrize("window", [0, 6])
def test_plain_paged_attention_matches_jax(H, window):
    q, k, v, bt, lens = _pool_inputs(H, seed=H + window)
    got = N(pa.paged_attention_plain(T(q), T(k), T(v), T(bt), T(lens),
                                     window=window))
    jq, jk, jv, jbt, jl = map(jnp.asarray, (q, k, v, bt, lens))
    want = np.asarray(jref.paged_attention_ref(jq, jk, jv, jbt, jl,
                                               window=window))
    pallas = np.asarray(jops.paged_attention(jq, jk, jv, jbt, jl,
                                             window=window,
                                             mode="interpret"))
    fallback = np.asarray(jattend(jq[:, None], jk, jv, jbt, jl,
                                  jhmap(H, H, KV), window=window,
                                  mode="xla"))[:, 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    act = lens > 0      # the fallback's inactive row is undefined
    np.testing.assert_allclose(got[act], fallback[act], rtol=0, atol=1e-5)
    assert not np.any(got[2])


@pytest.mark.parametrize("H", [4, 14])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_plain_paged_attention_quant_matches_jax(H, window, kv_bits):
    q, k, v, bt, lens = _pool_inputs(H, seed=H + window + kv_bits)
    kq, ks, vq, vs = _quant_pool(k, v, kv_bits)
    got = N(pa.paged_attention_quant_plain(
        T(q), T(kq), T(vq), T(ks), T(vs), T(bt), T(lens), window=window,
        kv_bits=kv_bits))
    jargs = tuple(map(jnp.asarray, (q, kq, vq, ks, vs, bt, lens)))
    want = np.asarray(jref.paged_attention_quant_ref(
        *jargs, window=window, kv_bits=kv_bits))
    pallas = np.asarray(jops.paged_attention_quant(
        *jargs, window=window, kv_bits=kv_bits, mode="interpret"))
    jq = jargs[0]
    fallback = np.asarray(jattend_q(
        jq[:, None], *jargs[1:], jhmap(H, H, KV), window=window,
        kv_bits=kv_bits, mode="xla"))[:, 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    act = lens > 0
    np.testing.assert_allclose(got[act], fallback[act], rtol=0, atol=1e-5)
    assert not np.any(got[2])


def test_model_paged_attend_dispatches_to_the_plain_version_on_cpu():
    q, k, v, bt, lens = _pool_inputs(4, seed=0)
    o = tattn.paged_decode_attend(T(q)[:, None], T(k), T(v), T(bt), T(lens),
                                  None)
    want = pa.paged_attention_plain(T(q), T(k), T(v), T(bt), T(lens))
    assert torch.equal(o[:, 0], want)
    # an uneven head map (3 query heads over 2 KV heads, the third parked
    # on KV head 0) goes to the dispatch as its table; no map there raises
    hmap = (0, 1, 0)
    o3 = tattn.paged_decode_attend(T(q)[:, None, :3], T(k), T(v), T(bt),
                                   T(lens), hmap)
    want3 = pa.paged_attention_plain(T(q)[:, :3].contiguous(), T(k), T(v),
                                     T(bt), T(lens), head_map=hmap)
    assert torch.equal(o3[:, 0], want3)
    with pytest.raises(ValueError, match="need a head map"):
        tattn.paged_decode_attend(T(q)[:, None, :3], T(k), T(v), T(bt),
                                  T(lens), None)


def test_paged_gather_matches_jax():
    from repro.models.attention import paged_gather as jgather
    _, k, _, bt, _ = _pool_inputs(4, seed=1)
    np.testing.assert_array_equal(
        N(tattn.paged_gather(T(k), T(bt))),
        np.asarray(jgather(jnp.asarray(k), jnp.asarray(bt))))


# ---------------------------------------------------------------------------
# pool write paths: floats and integer codes equal; scales within 1e-6
# relative; a code may differ by one unit only where x/scale lands on a
# rounding boundary in one package and not the other, and the share of
# such codes is stated (here: none is allowed beyond 0.5%)
# ---------------------------------------------------------------------------

CODE_FLIP_SHARE = 0.005


def assert_codes_match(got, want, kv_bits, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if kv_bits == 4:
        got = np.stack([got & 15, got >> 4], -1).astype(np.int16)
        want = np.stack([want & 15, want >> 4], -1).astype(np.int16)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (what, int(diff.max()))
    share = float((diff > 0).mean())
    assert share <= CODE_FLIP_SHARE, (what, share)


def assert_scales_match(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=0, err_msg=what)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_kv_encode_decode_match_jax(kv_bits):
    rows = np.random.default_rng(kv_bits).standard_normal(
        (6, 2, 32)).astype(np.float32)
    rows[0] = 0.0                               # zero scale -> zero codes
    js = jkv.kv_scale_of(jnp.max(jnp.abs(jnp.asarray(rows)), axis=-1),
                         kv_bits)
    ts = tkv.kv_scale_of(T(rows).abs().amax(-1), kv_bits)
    assert_scales_match(N(ts), js)
    jc = jkv.kv_encode(jnp.asarray(rows), js, kv_bits)
    tc = tkv.kv_encode(T(rows), ts, kv_bits)
    assert_codes_match(N(tc), jc, kv_bits)
    np.testing.assert_allclose(
        N(tkv.kv_decode(tc, ts, kv_bits)),
        np.asarray(jkv.kv_decode(jc, js, kv_bits)), rtol=1e-6, atol=0)
    assert not np.any(N(tkv.kv_decode(tc, ts, kv_bits))[0])


def _jax_pool(pool):
    return {k: jnp.asarray(v) for k, v in pool.items()}


def _torch_pool(pool):
    return {k: T(v) for k, v in pool.items()}


@pytest.mark.parametrize("kv_bits,dt", [(0, np.float32), (0, "bf16"),
                                        (8, None), (4, None)])
def test_write_prefill_matches_jax(kv_bits, dt):
    L, NBp, BSp, KVp, hdp, S = 2, 6, 4, 2, 8, 10
    rng = np.random.default_rng(7)
    cpb = 2 if kv_bits == 4 else 1
    if kv_bits:
        code_dt = np.int8 if kv_bits == 8 else np.uint8
        pool = {"k": np.zeros((L, NBp, BSp, KVp, hdp // cpb), code_dt),
                "v": np.zeros((L, NBp, BSp, KVp, hdp // cpb), code_dt),
                "k_scale": np.zeros((L, NBp, KVp), np.float32),
                "v_scale": np.zeros((L, NBp, KVp), np.float32)}
        pool["k_scale"][:, 2] = 99.0            # stale scale of a reused page
        pool["v_scale"][:, 1] = 5.0             # untouched page keeps its own
    else:
        pool = {"k": rng.standard_normal((L, NBp, BSp, KVp, hdp)),
                "v": rng.standard_normal((L, NBp, BSp, KVp, hdp))}
    k_seq = rng.standard_normal((L, S, KVp, hdp)).astype(np.float32)
    v_seq = rng.standard_normal((L, S, KVp, hdp)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    pos[5] = -1                                  # a dropped row
    table = np.asarray([2, 0, 4], np.int32)
    jp = _jax_pool(pool)
    tp = _torch_pool(pool)
    if dt == "bf16":
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
        tp = {k: v.bfloat16() for k, v in tp.items()}
    elif not kv_bits:
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
        tp = {k: v.float() for k, v in tp.items()}
    want = jkv.write_prefill(jp, jnp.asarray(k_seq), jnp.asarray(v_seq),
                             jnp.asarray(pos), jnp.asarray(table),
                             kv_bits=kv_bits)
    got = tkv.write_prefill(tp, T(k_seq), T(v_seq), T(pos), T(table),
                            kv_bits=kv_bits)
    assert got is tp                             # updated in place
    for name in ("k", "v"):
        if kv_bits:
            assert_codes_match(N(got[name]), want[name], kv_bits, name)
            assert_scales_match(N(got[name + "_scale"]),
                                want[name + "_scale"], name)
        else:
            np.testing.assert_array_equal(
                N(got[name].float()), np.asarray(want[name], np.float32))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_insert_matches_jax(dt):
    rng = np.random.default_rng(3)
    k = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    k_new = rng.standard_normal((4, 1, KV, hd)).astype(np.float32)
    v_new = rng.standard_normal((4, 1, KV, hd)).astype(np.float32)
    # slot 1 is inactive and its table row points at page 0, which slot 0
    # writes this step: the inactive write must not clobber it
    bt = np.asarray([[3, 0, 1], [0, 0, 0], [5, 6, 7], [8, 9, 2]], np.int32)
    pos = np.asarray([4, -1, 2, 9], np.int32)
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    jk, jv = jinsert(jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                     jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(bt),
                     jnp.asarray(pos))
    tk, tv = T(k).to(dt), T(v).to(dt)
    gk, gv = tattn.paged_insert(tk, tv, T(k_new), T(v_new), T(bt), T(pos))
    assert gk is tk and gv is tv                 # in place
    np.testing.assert_array_equal(N(gk.float()), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(N(gv.float()), np.asarray(jv, np.float32))
    # all slots inactive: nothing changes
    before = tk.clone()
    tattn.paged_insert(tk, tv, T(k_new), T(v_new), T(bt),
                       torch.full((4,), -1, dtype=torch.int32))
    assert torch.equal(tk, before)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_insert_quant_matches_jax(kv_bits):
    rng = np.random.default_rng(kv_bits)
    cpb = 2 if kv_bits == 4 else 1
    code_dt = np.int8 if kv_bits == 8 else np.uint8
    jp = [jnp.zeros((NB, BS, KV, hd // cpb), code_dt),
          jnp.zeros((NB, KV), jnp.float32)] * 2
    tp = [T(np.asarray(a)) for a in jp]
    bt = np.asarray([[3, 0, 1], [0, 0, 0], [5, 6, 7]], np.int32)
    # fresh pages, then a larger token raises the scale (old codes
    # rescale), then a smaller one (byte-stable); slot 1 stays inactive
    steps = [([0, -1, 4], 1.0), ([1, -1, 5], 4.0), ([2, -1, 6], 0.5),
             ([4, -1, 8], 2.0)]
    for pos, mag in steps:
        kn = (rng.standard_normal((3, 1, KV, hd)) * mag).astype(np.float32)
        vn = (rng.standard_normal((3, 1, KV, hd)) * mag).astype(np.float32)
        pos = np.asarray(pos, np.int32)
        jk, jks, jv, jvs = jinsert_q(jp[0], jp[2], jp[1], jp[3],
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(bt), jnp.asarray(pos),
                                     kv_bits=kv_bits)
        jp = [jk, jks, jv, jvs]
        tattn.paged_insert_quant(tp[0], tp[2], tp[1], tp[3], T(kn), T(vn),
                                 T(bt), T(pos), kv_bits=kv_bits)
        for got, want, what in zip(tp, jp, ("k", "k_scale", "v",
                                            "v_scale")):
            if what.endswith("scale"):
                assert_scales_match(N(got), want, what)
            else:
                assert_codes_match(N(got), want, kv_bits, what)


# ---------------------------------------------------------------------------
# decode_step_paged on qwen2 smoke (f32; logits within 1e-4, as in
# tests/test_torch_model.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    cfg = jax_cfg(ARCH).replace(compute_dtype="float32")
    return jax.device_get(jax_init(jax.random.PRNGKey(0), cfg,
                                   JPlan(remat=False)))


def _decode_inputs(cfg, kv_bits, seed=11):
    """A random pool (f32 pages, or JAX-encoded codes), distinct pages per
    slot, mixed positions with one inactive slot, and tokens."""
    rng = np.random.default_rng(seed)
    L, KVc, hdc, NBc, BSc, maxb = (cfg.n_layers, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, 16, 4, 4)
    rows = rng.standard_normal((L, NBc, BSc, KVc, hdc)).astype(np.float32)
    pool = {"k": rows, "v": rng.standard_normal(rows.shape).astype(
        np.float32)}
    if kv_bits:
        for name in ("k", "v"):
            s = jkv.kv_scale_of(jnp.max(jnp.abs(pool[name]), axis=(2, 4)),
                                kv_bits)                 # (L, NB, KV)
            pool[name] = np.asarray(jkv.kv_encode(
                jnp.asarray(pool[name]), s[:, :, None], kv_bits))
            pool[name + "_scale"] = np.asarray(s)
    bt = rng.permutation(NBc)[:4 * maxb].reshape(4, maxb).astype(np.int32)
    pos = np.asarray([13, -1, 5, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    return pool, bt, pos, tokens


def _decode_both(jp, tp, kv_bits):
    jc = jax_cfg(ARCH).replace(compute_dtype="float32")
    tc = get_smoke_config(ARCH).replace(compute_dtype="float32")
    pool, bt, pos, tokens = _decode_inputs(tc, kv_bits)
    jplan = JPlan(remat=False, cache_dtype=jnp.float32, kv_bits=kv_bits)
    tplan = BuildPlan(cache_dtype=torch.float32, kv_bits=kv_bits)
    jl, jpool = jm.decode_step_paged(jp, jc, jplan, _jax_pool(pool),
                                     jnp.asarray(bt), jnp.asarray(tokens),
                                     jnp.asarray(pos))
    with torch.no_grad():
        tl, tpool = tm.decode_step_paged(tp, tc, tplan, _torch_pool(pool),
                                         T(bt), T(tokens).long(), T(pos))
    act = pos >= 0        # an inactive slot's logits are garbage in both
    np.testing.assert_allclose(N(tl)[act], np.asarray(jl)[act], rtol=1e-4,
                               atol=1e-4)
    for name in jpool:
        if name.endswith("scale"):
            assert_scales_match(N(tpool[name]), jpool[name], name)
        elif kv_bits:
            assert_codes_match(N(tpool[name]), jpool[name], kv_bits, name)
        else:
            np.testing.assert_allclose(N(tpool[name]), jpool[name],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_decode_step_paged_matches_jax(jparams, kv_bits):
    _decode_both(jparams, params_from_numpy(jparams, "cpu"), kv_bits)


@pytest.fixture(scope="module")
def jax_qparams(jparams):
    spec = JSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
                 order="greedy")
    cfg = jax_cfg(ARCH).replace(compute_dtype="float32")
    tokens = np.random.default_rng(2).integers(0, 256, (2, 80))
    jq, _ = jax_quantize(jparams, cfg, JPlan(remat=False),
                         jnp.asarray(tokens, jnp.int32), spec, method="rtn",
                         guards=False)
    return jq


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_packed_decode_step_paged_matches_jax(jax_qparams, kv_bits):
    """Both packages decode from the same converted packed codes."""
    jc = jax_cfg(ARCH).replace(compute_dtype="float32")
    tc = get_smoke_config(ARCH).replace(compute_dtype="float32")
    tq = qparams_from_numpy(jax.device_get(jax_qparams), "cpu")
    _decode_both(jax_serving(jax_qparams, jc), serving_params(tq, tc),
                 kv_bits)


def test_packed_runtime_tokens_match_jax(jax_qparams):
    """Packed-QT serving end to end: both runtimes serve the same converted
    packed codes under staggered traffic; greedy tokens identical."""
    from repro.serve import Runtime as JRuntime
    from repro.serve import ServeConfig as JServeConfig
    from repro_torch.serve import Runtime, ServeConfig
    jc = jax_cfg(ARCH).replace(compute_dtype="float32")
    tc = get_smoke_config(ARCH).replace(compute_dtype="float32")
    sc = dict(max_slots=2, block_size=8, num_blocks=12, buckets=(8, 16, 32),
              max_blocks_per_slot=6)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32)
               for n in (7, 16, 12)]

    def drive(rt):
        reqs = [rt.submit(p, max_new_tokens=5) for p in prompts[:2]]
        rt.step()
        reqs.append(rt.submit(prompts[2], max_new_tokens=5))
        rt.run()
        return [list(r.out_tokens) for r in reqs]

    want = drive(JRuntime(jax_serving(jax_qparams, jc), jc,
                          JPlan(remat=False, cache_dtype=jnp.float32),
                          JServeConfig(**sc)))
    tq = qparams_from_numpy(jax.device_get(jax_qparams), "cpu")
    got = drive(Runtime(serving_params(tq, tc), tc,
                        BuildPlan(cache_dtype=torch.float32),
                        ServeConfig(**sc), device="cpu"))
    assert got == want
