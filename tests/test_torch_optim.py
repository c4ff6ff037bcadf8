"""The port's training data and optimizer against the JAX package's, from
seeded numpy inputs: the synthetic stream and the prefetching loader (bit
for bit), the int8 moment codecs and the 2-bit packing (bit for bit),
AdamW with f32 and int8 moments, the schedules and global-norm clipping;
then JAX's tests/test_train.py optimizer checks, run on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import ShardedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import batches as jbatches
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import constant as jconstant
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.data import ShardedLoader, SyntheticLM, batches
from repro_torch.kernels import adamw as kadamw
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, constant, warmup_cosine)
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(2)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# ---------------------------------------------------------------------------
# data: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed", [(256, 0), (152064, 3)])
def test_synthetic_stream_equals_jax(vocab, seed):
    a, b = SyntheticLM(vocab, seed), JSynthetic(vocab, seed)
    assert np.array_equal(a.offsets, b.offsets)
    for batch, seq, step in ((8, 64, 0), (3, 17, 5), (8, 128, 9999)):
        x, y = a.sample(batch, seq, step), b.sample(batch, seq, step)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    for x, y, _ in zip(batches(vocab, 4, 16, seed=seed, start_step=7),
                       jbatches(vocab, 4, 16, seed=seed, start_step=7),
                       range(3)):
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_sharded_loader_equals_jax():
    """The prefetching loaders give the same batches in the same order
    from a start step, and the same resumable position."""
    mine = ShardedLoader(512, 8, 32, seed=2, start_step=4, prefetch=3)
    ref = JLoader(512, 8, 32, seed=2, start_step=4, prefetch=3)
    try:
        for _ in range(5):
            x, y = next(mine), next(ref)
            assert all(np.array_equal(x[k], y[k]) for k in ("tokens",
                                                            "labels"))
        assert mine.state() == ref.state() == {"step": 9}
    finally:
        mine.close()
        ref.close()
    assert mine._stop.is_set() and mine._q.empty()


# ---------------------------------------------------------------------------
# the int8 moment codecs: bit for bit
# ---------------------------------------------------------------------------

CODEC_SHAPES = [(64, 300), (7, 130), (3, 4, 256), (5,), ()]


@pytest.mark.parametrize("shape", CODEC_SHAPES, ids=str)
def test_q8_codec_equals_jax(shape):
    """The signed codec (int8 codes, block scales, 2-bit EF plane) and its
    decode, and the power-law codec of the second moment and its decode,
    equal JAX's bit for bit (blocks padded along the last dim)."""
    rs = np.random.RandomState(len(shape) + 7)
    x = np.asarray(rs.standard_normal(shape) * 1e-3, dtype=np.float32)
    if x.size > 3:
        x.reshape(-1)[:3] = 0.0                  # exact zeros, a zero block
    enc, jenc = kadamw.encode_m(torch.from_numpy(x)), jadamw._q8_encode(
        jnp.asarray(x))
    assert set(enc) == set(jenc) == {"q", "scale", "ef"}
    for k in enc:
        assert _np(enc[k]).dtype == np.asarray(jenc[k]).dtype, k
        assert np.array_equal(_np(enc[k]), np.asarray(jenc[k])), k
    dec = kadamw.decode_m(enc, shape)
    assert np.array_equal(_np(dec), np.asarray(jadamw._q8_decode(jenc,
                                                                 shape)))
    v = np.asarray(np.square(x) + np.float32(1e-12) * (rs.rand(*shape) > 0.5),
                   dtype=np.float32)
    enc, jenc = (kadamw.encode_v(torch.from_numpy(v)),
                 jadamw._q8_encode_pow(jnp.asarray(v)))
    assert set(enc) == set(jenc) == {"q", "scale"}
    for k in enc:
        assert np.array_equal(_np(enc[k]), np.asarray(jenc[k])), k
    assert np.array_equal(_np(kadamw.decode_v(enc, shape)),
                          np.asarray(jadamw._q8_decode_pow(jenc, shape)))


def test_pack2_equals_jax():
    codes = np.random.RandomState(0).randint(0, 4, (6, 512)).astype(np.uint8)
    packed = kadamw.pack2(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8
    assert np.array_equal(_np(packed),
                          np.asarray(jadamw._pack2(jnp.asarray(codes))))
    assert np.array_equal(_np(kadamw.unpack2(packed)), codes)


# ---------------------------------------------------------------------------
# AdamW, schedules, clipping against JAX
# ---------------------------------------------------------------------------

def _tree(rs):
    return {"a": {"w": rs.standard_normal((16, 300)).astype(np.float32)},
            "b": rs.standard_normal((130,)).astype(np.float32),
            "s": np.float32(0.5)}


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v)) for k, v in t.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
@pytest.mark.parametrize("shape", [(64, 300), (7, 130)])
def test_adamw_tracks_jax_on_the_same_grads(shape, moment_dtype):
    """JAX's test_int8_moments_track_f32 setting (its shapes, 5 steps at lr
    1e-2), the same seeded grads into both packages: every step's int8
    moment state (codes, scales, EF plane) equals JAX's bit for bit, f32
    moments agree to 1e-6 of their leaf's max, and the params to 1e-6
    (the bias corrections' powers come from two libraries' pow)."""
    rs = np.random.RandomState(3)
    p0 = rs.standard_normal(shape).astype(np.float32)
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    jcfg = JAdamWConfig(moment_dtype=moment_dtype)
    tp, jp = {"w": torch.from_numpy(p0)}, {"w": jnp.asarray(p0)}
    ts, js = adamw_init(tp, cfg), jadamw.adamw_init(jp, jcfg)
    for i in range(5):
        g = np.random.RandomState(100 + i).standard_normal(shape).astype(
            np.float32)
        tp, ts = adamw_update({"w": torch.from_numpy(g)}, ts, tp, cfg,
                              torch.tensor(1e-2))
        jp, js = jadamw.adamw_update({"w": jnp.asarray(g)}, js, jp, jcfg,
                                     jnp.float32(1e-2))
        for mom in ("m", "v"):
            a, b = ts[mom]["w"], js[mom]["w"]
            if moment_dtype == "int8":
                assert set(a) == set(b)
                for k in a:
                    assert np.array_equal(_np(a[k]), np.asarray(b[k])), (
                        i, mom, k)
            else:
                top = float(np.abs(np.asarray(b)).max())
                np.testing.assert_allclose(_np(a), np.asarray(b),
                                           atol=1e-6 * top, rtol=0)
        np.testing.assert_allclose(_np(tp["w"]), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_update_matches_jax(moment_dtype):
    """Four steps of adamw_update from the same params and gradients: the
    step counter and the params agree to 1e-6 of each leaf's size (f32 in
    the same order; only the bias corrections' powers come from two
    libraries' pow), the int8 moments' codes to within one code step
    (a bias correction a last bit apart can round a code the other way)
    and every decoded moment to 1e-5 of its leaf's max."""
    rs = np.random.RandomState(1)
    p = _tree(rs)
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    jcfg = JAdamWConfig(moment_dtype=moment_dtype)
    tp, jp = _torch_tree(p), jax.tree_util.tree_map(jnp.asarray, p)
    ts, js = adamw_init(tp, cfg), jadamw.adamw_init(jp, jcfg)
    for i in range(4):
        g = _tree(np.random.RandomState(10 + i))
        lr = np.float32(1e-2 * (i + 1))
        tp, ts = adamw_update(_torch_tree(g), ts, tp, cfg,
                              torch.tensor(lr))
        jp, js = jadamw.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp, jcfg,
            jnp.float32(lr))
    assert int(ts["step"]) == int(js["step"]) == 4
    for k, want in (("b", jp["b"]), ("s", jp["s"])):
        np.testing.assert_allclose(_np(tp[k]), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(_np(tp["a"]["w"]), np.asarray(jp["a"]["w"]),
                               rtol=1e-6, atol=1e-6)
    for mom, signed in (("m", True), ("v", False)):
        for key in (("b",), ("s",), ("a", "w")):
            a, b = ts[mom], js[mom]
            for part in key:
                a, b = a[part], b[part]
            shape = np.asarray(jp[key[0]] if len(key) == 1
                               else jp["a"]["w"]).shape
            if moment_dtype == "int8":
                assert np.abs(_np(a["q"]).astype(int)
                              - np.asarray(b["q"]).astype(int)).max() <= 1
                dec = (kadamw.decode_m if signed else kadamw.decode_v)(
                    a, shape)
                jdec = jadamw._moment_read(b, "int8", shape, signed)
            else:
                dec, jdec = a, b
            top = float(np.abs(np.asarray(jdec)).max())
            np.testing.assert_allclose(_np(dec), np.asarray(jdec),
                                       atol=1e-5 * top, rtol=0)


def test_adamw_update_leaves_its_inputs_and_the_owned_form_writes_them():
    """`adamw_update` leaves its inputs as they were, as JAX's arrays are;
    `adamw_update_` (the train step's, which owns its state) writes the
    same values into the input tensors (an int8 codec dict's too)."""
    rs = np.random.RandomState(4)
    for moment_dtype in ("float32", "int8"):
        cfg = AdamWConfig(moment_dtype=moment_dtype)
        p = _torch_tree(_tree(rs))
        s = adamw_init(p, cfg)
        g = _torch_tree(_tree(rs))
        before = torch.utils._pytree.tree_map(torch.clone, (p, s))
        want_p, want_s = adamw_update(g, s, p, cfg, torch.tensor(1e-2))
        for a, b in zip(torch.utils._pytree.tree_leaves((p, s)),
                        torch.utils._pytree.tree_leaves(before)):
            assert torch.equal(a, b)
        ptrs = [t.data_ptr() for t in torch.utils._pytree.tree_leaves(
            (p, s["m"], s["v"]))]
        got_p, got_s = tadamw.adamw_update_(g, s, p, cfg,
                                            torch.tensor(1e-2))
        after = torch.utils._pytree.tree_leaves((got_p, got_s["m"],
                                                 got_s["v"]))
        assert [t.data_ptr() for t in after] == ptrs
        for a, b in zip(torch.utils._pytree.tree_leaves((got_p, got_s)),
                        torch.utils._pytree.tree_leaves((want_p, want_s))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_owned_update_in_slabs_equals_the_whole_leaf(moment_dtype,
                                                     monkeypatch):
    """`adamw_update_` updates a leaf of more than CHUNK entries a slab of
    rows at a time (a ragged last slab included): three steps give the
    params, moments, scales and EF planes of the whole-leaf
    `adamw_update` (the default CHUNK, above every leaf here) bit for
    bit."""
    rs = np.random.RandomState(6)
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    p = _torch_tree(_tree(rs))
    assert max(x.numel() for x in torch.utils._pytree.tree_leaves(p)) > 1000
    want_p, want_s = p, adamw_init(p, cfg)
    got_p = torch.utils._pytree.tree_map(torch.clone, p)
    got_s = adamw_init(got_p, cfg)
    writes = []                                  # (p, m, v) writes a step
    write_into = kadamw._write_into
    monkeypatch.setattr(kadamw, "_write_into",
                        lambda old, new: (writes.append(1),
                                          write_into(old, new)))
    for _ in range(3):
        g = _torch_tree(_tree(rs))
        want_p, want_s = adamw_update(g, want_s, want_p, cfg,
                                      torch.tensor(1e-2))
        assert len(writes) == 3 * 3              # three whole leaves
        writes.clear()
        # the slab loop is the plain leaf update's (kernels/adamw.py)
        with monkeypatch.context() as mp:
            mp.setattr(kadamw, "CHUNK", 1000)    # slabs of 3 rows of 300
            got_p, got_s = tadamw.adamw_update_(g, got_s, got_p, cfg,
                                                torch.tensor(1e-2))
        assert len(writes) == 3 * (6 + 1 + 1)    # 16 rows in 6 slabs
        writes.clear()
    for a, b in zip(torch.utils._pytree.tree_leaves((got_p, got_s)),
                    torch.utils._pytree.tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)


def test_schedules_match_jax():
    steps = list(range(0, 130, 7)) + [10, 99, 100, 101]
    for s in steps:
        kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100)
        got = float(warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw))
        want = float(jwarmup_cosine(jnp.int32(s), **kw))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s
        assert float(constant(s, base_lr=0.5)) == float(
            jconstant(s, base_lr=0.5))


def test_clip_by_global_norm_matches_jax():
    rs = np.random.RandomState(2)
    g = _tree(rs)
    for max_norm in (1.0, 1e3):
        got, norm = clip_by_global_norm(_torch_tree(g), max_norm)
        want, jnorm = jclip(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
        np.testing.assert_allclose(_np(got["a"]["w"]),
                                   np.asarray(want["a"]["w"]), rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# JAX's tests/test_train.py optimizer checks, on the port
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_math():
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    cfg = AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    st = adamw_init(p, cfg)
    p0 = p["w"].numpy().copy()
    newp, st = adamw_update(g, st, p, cfg, torch.tensor(0.1))
    m = 0.1 * g["w"].numpy()
    v = 0.001 * g["w"].numpy() ** 2
    mh, vh = m / 0.1, v / 0.001
    want = p0 - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(_np(newp["w"]), want, rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 300), (7, 130)])
def test_int8_moments_track_f32(shape):
    """The int8 trajectory tracks f32 within 10% of the max param change
    (JAX's gate): the EF residual keeps the EMA from compounding rounding
    error; both shapes are block-unaligned."""
    rs = np.random.RandomState(3)
    p = {"w": torch.from_numpy(rs.standard_normal(shape).astype(np.float32))}
    cfg8 = AdamWConfig(moment_dtype="int8")
    cfg32 = AdamWConfig(moment_dtype="float32")
    s8, s32 = adamw_init(p, cfg8), adamw_init(p, cfg32)
    p8 = p32 = p
    for i in range(5):
        g = {"w": torch.from_numpy(np.random.RandomState(100 + i)
                                   .standard_normal(shape)
                                   .astype(np.float32))}
        p8, s8 = adamw_update(g, s8, p8, cfg8, torch.tensor(1e-2))
        p32, s32 = adamw_update(g, s32, p32, cfg32, torch.tensor(1e-2))
    diff = float((p8["w"] - p32["w"]).abs().max())
    scale = float((p32["w"] - p["w"]).abs().max())
    assert diff < 0.1 * scale, (diff, scale)


def test_int8_moment_memory_shrinks():
    p = {"w": torch.zeros(256, 1024)}
    nbytes = {d: sum(t.numel() * t.element_size() for t in
                     torch.utils._pytree.tree_leaves(
                         adamw_init(p, AdamWConfig(moment_dtype=d))))
              for d in ("int8", "float32")}
    assert nbytes["int8"] < 0.3 * nbytes["float32"]


def test_grad_clip_and_schedule():
    tree = {"a": torch.full((10,), 3.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(90.0), rtol=1e-5)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    lrs = [float(warmup_cosine(s, base_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in (0, 5, 10, 100)]
    assert lrs[0] == 0.0 and abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6 and lrs[3] < 0.2
