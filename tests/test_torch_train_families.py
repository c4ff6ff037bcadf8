"""Gradients of the non-dense families, the port against the JAX package
from seeded numpy inputs and the same (JAX-initialized) weights: the
selective-scan repair (the chunk scan's adjoint against JAX and a
sequential f64 loop, the no-grad path kept bit for bit, and the fault it
closes), then `lm_loss` and its f32 gradient leaf by leaf on the smoke
configs of deepseek-67b, the MoE pair, hymba (remat on and off), rwkv6,
musicgen, the VLM and the encoder. Train steps, Trainers, checkpoints
and the launcher for these families are
tests/test_torch_trainer_families.py.

Tolerances are tests/test_torch_train.py's: the loss to 1e-5 (relative),
every leaf's gradient to 2e-4 of its max |g|; an MoE model's aux loss to
1e-4. The VLM's bound is derived in its test from JAX's own spread.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro.configs import get_smoke_config as jax_cfg
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import lm_loss as jlm_loss
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import QuantSpec, quantize_model
from repro_torch.models import BuildPlan, lm_loss
from repro_torch.models import ssm as tssm
from test_torch_train import (_as_torch, _batch, _cfgs, _check_grads,
                              _jparams, _leaves, _port_tree)

torch.set_num_threads(2)

FAMILIES = ["deepseek-67b", "granite-moe-3b-a800m",
            "llama4-maverick-400b-a17b", "hymba-1.5b", "rwkv6-7b",
            "musicgen-large"]
MOE = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
HYMBA = "hymba-1.5b"
VLM, ENCODER = "llama-3.2-vision-90b", "vit-base-16"
VLM_GATE = 0.5    # the cross gates (zero at init: the layer is the identity)
# the VLM's per-leaf bound: this many times JAX's own jit-vs-eager spread
# (its worst leaf) at the same inputs (measured: the port at 1.14x)
VLM_SPREAD_K = 2.0
SSM_RTOL = 1e-5   # tests/test_torch_ssm.py's, the selective SSM at f32


def _names(tree):
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in pytree.tree_flatten_with_path(tree)[0]]


def _jax_value_and_grad(jc, jp, batch, jit=True):
    fn = jax.value_and_grad(
        lambda p: jlm_loss(p, jc, JPlan(remat=False),
                           {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)
    (loss, aux), g = (jax.jit(fn) if jit else fn)(
        jax.tree_util.tree_map(jnp.asarray, jp))
    return float(loss), {k: float(v) for k, v in aux.items()}, \
        jax.device_get(g)


def _port_value_and_grad(tc, jp, batch, plan):
    tp = params_from_numpy(jp, "cpu")
    leaves = [t.requires_grad_(True) for t in _leaves(tp)]
    loss, aux = lm_loss(tp, tc, plan, _as_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), {k: float(v.detach())
                                   for k, v in aux.items()},
            pytree.tree_unflatten(list(grads), pytree.tree_structure(tp)))


@functools.lru_cache(maxsize=None)
def _jax_lm(arch):
    jc, _ = _cfgs(arch)
    return _jax_value_and_grad(jc, _jparams(arch),
                               _batch(jc.vocab_size, 4, 40, 3))


# ---------------------------------------------------------------------------
# the selective scan: its gradient (ChunkScan) and the no-grad path
# ---------------------------------------------------------------------------

def _scan_inputs(seed=0, B=2, C=8, di=3, n=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, (B, C, di, n)).astype(np.float32)
    b = rng.standard_normal((B, C, di, n)).astype(np.float32)
    h0 = rng.standard_normal((B, di, n)).astype(np.float32)
    g = rng.standard_normal((B, C, di, n)).astype(np.float32)
    return a, b, h0, g


def _f64_loop(a, b, h0):
    """h_t = a_t·h_{t-1} + b_t one step at a time, in f64."""
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


@pytest.mark.parametrize("C", [1, 8, 13])
def test_chunk_scan_gradient_matches_a_sequential_f64_loop(C):
    """ChunkScan's states equal the in-place scan's bit for bit, and its
    adjoint (dL/da, dL/db, dL/dh0 for a random cotangent) matches autograd
    through a step-by-step f64 loop to 1e-5 of each gradient's max."""
    arrs = _scan_inputs(C=C)
    a, b, h0, g = (torch.from_numpy(x) for x in arrs)
    with torch.no_grad():
        want_h = tssm._scan_chunk(a.clone(), b.clone(), h0)
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    h = tssm.ChunkScan.apply(*leaves)
    assert torch.equal(h.detach(), want_h)
    got = torch.autograd.grad(h, leaves, g)
    ref = [t.double().requires_grad_(True) for t in (a, b, h0)]
    want = torch.autograd.grad(_f64_loop(*ref), ref, g.double())
    np.testing.assert_allclose(h.detach().double(), _f64_loop(
        *(t.double() for t in (a, b, h0))), rtol=1e-5, atol=1e-5)
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        top = float(y.abs().max())
        assert float((x.double() - y).abs().max()) <= 1e-5 * top, name


def _ssm_case(T, seed=4):
    """hymba's smoke SSM params (the JAX init), an input and a non-zero
    state (tests/test_torch_ssm.py's case), f32."""
    cfg = jax_cfg(HYMBA).replace(compute_dtype="float32")
    p = jax.device_get(jssm.init_ssm(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    st = jssm.init_ssm_state(2, cfg)
    st = jssm.SSMState(
        h=rng.standard_normal(st.h.shape).astype(np.float32),
        conv=rng.standard_normal(st.conv.shape).astype(np.float32))
    tcfg = get_smoke_config(HYMBA).replace(compute_dtype="float32")
    return cfg, tcfg, {k: np.array(v) for k, v in p.items()}, x, st


@pytest.mark.parametrize("T,chunk", [(16, 1024), (64, 16)])
def test_apply_ssm_gradient_matches_jax(T, chunk):
    """jax.grad against torch.autograd of one scalar of apply_ssm's
    outputs and final state (random weights on y, h and conv), with
    respect to every SSM leaf, the input and the initial state: one chunk,
    and four chunks (the state handed from chunk to chunk); each to 2e-4
    of its max |g|."""
    cfg, tcfg, p, x, st = _ssm_case(T)
    rng = np.random.default_rng(T)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    wh = rng.standard_normal(st.h.shape).astype(np.float32)
    wc = rng.standard_normal(st.conv.shape).astype(np.float32)

    def jloss(p, x, h, conv):
        y, s = jssm.apply_ssm(p, x, cfg, jssm.SSMState(h=h, conv=conv),
                              chunk=chunk)
        return (jnp.sum(y * wy) + jnp.sum(s.h * wh)
                + jnp.sum(s.conv * wc))

    want = jax.device_get(jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *jax.tree_util.tree_map(jnp.asarray, (p, x, st.h, st.conv))))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx, th, tconv = (torch.from_numpy(np.array(v)).requires_grad_(True)
                     for v in (x, st.h, st.conv))
    y, s = tssm.apply_ssm(tp, tx, tcfg, tssm.SSMState(th, tconv),
                          chunk=chunk)
    loss = ((y * torch.from_numpy(wy)).sum()
            + (s.h * torch.from_numpy(wh)).sum()
            + (s.conv * torch.from_numpy(wc)).sum())
    got = torch.autograd.grad(loss, list(tp.values()) + [tx, th, tconv])
    wanted = [want[0][k] for k in tp] + list(want[1:])
    for name, a, b in zip(list(tp) + ["x", "h0", "conv0"], got, wanted):
        b = np.asarray(b)
        top = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= 2e-4 * top, (
            name, float(np.abs(a.numpy() - b).max()), top)


def _pre_repair_terms(p, xi, cfg):
    """`ssm._selective_terms` as it was before the scan had a gradient:
    the exp in place."""
    _, _, n, dt_rank, _ = tssm._dims(cfg)
    xdbc = torch.einsum("btd,dr->btr", xi, p["w_xproj"].to(xi.dtype))
    dt_raw, b_in, c_in = torch.split(xdbc, [dt_rank, n, n], dim=-1)
    dt = F.softplus(
        torch.einsum("btr,rd->btd", dt_raw, p["w_dt"].to(xi.dtype)).float()
        + p["b_dt"].float())
    a = -torch.exp(p["a_log"].float())
    a_t = (dt[..., None] * a).exp_()
    bx = (dt * xi.float())[..., None] * b_in.float()[:, :, None, :]
    return a_t, bx, c_in.float()


def _pre_repair_scan(a, b, h0):
    """`ssm._scan_chunk` as it was: in place of a and b, under autograd
    too."""
    C = a.shape[1]
    s = 1
    while s < C:
        b[:, s:] += a[:, s:] * b[:, :-s]
        a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    return b.addcmul_(a, h0[:, None])


def _pre_repair_recurrence(sel, xi, h0, *, cfg, chunk):
    """`ssm._ssm_recurrence` as it was before the repair."""
    ys = []
    h = h0
    for c0 in range(0, xi.shape[1], chunk):
        a_t, b_t, c_in = _pre_repair_terms(sel, xi[:, c0:c0 + chunk], cfg)
        hs = _pre_repair_scan(a_t, b_t, h)
        del a_t
        ys.append(torch.einsum("btdn,btn->btd", hs, c_in))
        h = hs[:, -1].clone()
        del hs, b_t
    return torch.cat(ys, dim=1) if len(ys) > 1 else ys[0], h


@pytest.mark.parametrize("T,chunk", [(1, 1024), (16, 1024), (64, 16)])
def test_no_grad_ssm_is_the_pre_repair_code_bit_for_bit(T, chunk):
    """Under torch.no_grad apply_ssm's outputs and states equal the
    pre-repair recurrence's bit for bit (and JAX's within 1e-5, as
    tests/test_torch_ssm.py holds them); with autograd recording, the
    forward gives the same bits again."""
    cfg, tcfg, p, x, st = _ssm_case(T)
    jy, jst = jssm.apply_ssm(p, jnp.asarray(x), cfg, st, chunk=chunk)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tst = tssm.SSMState(torch.from_numpy(st.h), torch.from_numpy(st.conv))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        y, s = tssm.apply_ssm(tp, tx, tcfg, tst, chunk=chunk)
    real = tssm._ssm_recurrence
    tssm._ssm_recurrence = _pre_repair_recurrence
    try:
        with torch.no_grad():
            y0, s0 = tssm.apply_ssm(tp, tx, tcfg, tst, chunk=chunk)
    finally:
        tssm._ssm_recurrence = real
    assert torch.equal(y, y0) and torch.equal(s.h, s0.h) \
        and torch.equal(s.conv, s0.conv)
    yg, sg = tssm.apply_ssm({k: v.clone().requires_grad_(True)
                             for k, v in tp.items()}, tx, tcfg, tst,
                            chunk=chunk)
    assert torch.equal(yg.detach(), y) and torch.equal(sg.h.detach(), s.h)
    for got, want in ((y, jy), (s.h, jst.h), (s.conv, jst.conv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=SSM_RTOL,
                                   atol=SSM_RTOL * float(np.abs(want).max()))


def test_hymba_codes_are_the_pre_repair_codes():
    """A hymba smoke quantize (staged, comq) gives the pre-repair
    recurrence's codes, scales and zero-points bit for bit."""
    _, tc = _cfgs(HYMBA)
    params = params_from_numpy(_jparams(HYMBA), "cpu")
    calib = torch.from_numpy(_batch(tc.vocab_size, 2, 32, 7)["tokens"])
    spec = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=2,
                     order="greedy")
    with torch.no_grad():
        now, _ = quantize_model(params, tc, BuildPlan(), calib, spec,
                                method="comq")
    real = tssm._ssm_recurrence
    tssm._ssm_recurrence = _pre_repair_recurrence
    try:
        with torch.no_grad():
            before, _ = quantize_model(params, tc, BuildPlan(), calib, spec,
                                       method="comq")
    finally:
        tssm._ssm_recurrence = real
    a, b = now["__qlayers__"], before["__qlayers__"]
    assert a.keys() == b.keys()
    leaves = 0
    for key in a:
        for x, y in zip(pytree.tree_leaves(a[key]), pytree.tree_leaves(
                b[key])):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), key
                leaves += 1
    assert leaves > 0


def test_pre_repair_scan_had_no_correct_gradient():
    """The fault the repair closes, on the pre-repair recurrence: without
    remat autograd refuses the in-place scan; with remat (the default
    plan, a non-reentrant checkpoint recomputing the layer) it returns a
    gradient far from JAX's — the worst leaf off by about its own max
    (measured 1.06·max|g| on layers.1.ssm.w_dt) — while the loss is JAX's."""
    jl, _, jg = _jax_lm(HYMBA)
    jc, tc = _cfgs(HYMBA)
    batch = _batch(jc.vocab_size, 4, 40, 3)
    real = tssm._ssm_recurrence
    tssm._ssm_recurrence = _pre_repair_recurrence
    try:
        with pytest.raises(RuntimeError, match="inplace operation"):
            _port_value_and_grad(tc, _jparams(HYMBA), batch,
                                 BuildPlan(remat=False))
        loss, _, grads = _port_value_and_grad(tc, _jparams(HYMBA), batch,
                                              BuildPlan(remat=True))
    finally:
        tssm._ssm_recurrence = real
    assert loss == pytest.approx(jl, rel=1e-5)
    want = _port_tree(jg)
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(_leaves(grads), _leaves(want)))
    assert worst > 0.5


# ---------------------------------------------------------------------------
# lm_loss and its gradient against JAX, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,remat", [(a, True) for a in FAMILIES]
                         + [(HYMBA, False)])
def test_lm_loss_and_f32_grads_match_jax(arch, remat):
    """f32 compute, the JAX init, tests/test_torch_train.py's batch: the
    loss to 1e-5, the z-loss to 1e-4 and an MoE model's aux loss (its
    routing, capacity drops and load balance) to 1e-4; every leaf's
    gradient to 2e-4 of its max |g| (the port's default plan
    rematerializes each layer; hymba also without remat)."""
    jl, jaux, jg = _jax_lm(arch)
    jc, tc = _cfgs(arch)
    loss, aux, grads = _port_value_and_grad(
        tc, _jparams(arch), _batch(jc.vocab_size, 4, 40, 3),
        BuildPlan(remat=remat))
    assert loss == pytest.approx(jl, rel=1e-5)
    assert aux["z_loss"] == pytest.approx(jaux["z_loss"], rel=1e-4)
    if arch in MOE:
        assert jaux["aux"] > 1.0
        assert aux["aux"] == pytest.approx(jaux["aux"], rel=1e-4)
    _check_grads(grads, _port_tree(jg), False, arch)


def _vlm_inputs():
    """The gated smoke VLM params (JAX init) and tests/test_torch_train.py's
    batch with image features from a numpy seed."""
    jc = jax_cfg(VLM).replace(compute_dtype="float32")
    jp = jax.device_get(jax_init(jax.random.PRNGKey(0), jc,
                                 JPlan(remat=False)))
    cross = dict(jp["groups"]["cross"])
    for name in ("gate_attn", "gate_mlp"):
        cross[name] = np.full_like(np.asarray(cross[name]), VLM_GATE)
    jp = {**jp, "groups": {**jp["groups"], "cross": cross}}
    ca = jc.cross_attn
    batch = dict(_batch(jc.vocab_size, 4, 40, 3))
    batch["vision_embeds"] = np.random.default_rng(3).standard_normal(
        (4, ca.n_vision_tokens, ca.vision_dim)).astype(np.float32)
    return jc, jp, batch


def test_vlm_lm_loss_and_grads_match_jax():
    """The VLM's lm_loss from batch["vision_embeds"] (10 smoke layers in 2
    groups, the cross gates at 0.5): the loss to 1e-5, and every leaf
    within VLM_SPREAD_K times JAX's own jit-vs-eager spread of the same
    gradient (its worst leaf, as a fraction of that leaf's max |g|) — the
    near-hard attention init moves every leaf's gradient by O(1e-3) under
    a rounding-level change (ROADMAP "Known behaviours"); measured: JAX's
    spread 6.4e-3, the port 7.2e-3."""
    jc, jp, batch = _vlm_inputs()
    tc = get_smoke_config(VLM).replace(compute_dtype="float32")
    jl, _, jit_g = _jax_value_and_grad(jc, jp, batch)
    _, _, eager_g = _jax_value_and_grad(jc, jp, batch, jit=False)
    loss, _, grads = _port_value_and_grad(tc, jp, batch, BuildPlan())
    assert loss == pytest.approx(jl, rel=1e-5)
    want, eager = _port_tree(jit_g), _port_tree(eager_g)
    spread = max(float((e - w).abs().max()) / float(w.abs().max())
                 for e, w in zip(_leaves(eager), _leaves(want)))
    assert 2e-4 < spread < 2e-2, spread
    names = _names(want)
    assert any(n.startswith("groups.cross.0.xattn") for n in names)
    for name, a, b in zip(names, _leaves(grads), _leaves(want)):
        top = float(b.abs().max())
        assert top > 0, name
        assert float((a - b).abs().max()) <= VLM_SPREAD_K * spread * top, (
            name, float((a - b).abs().max()) / top, spread)


def test_encoder_lm_loss_and_grads_match_jax():
    """The encoder's lm_loss from batch["embeds"] and batch["labels"]
    (vit-base-16 smoke, 197 tokens, non-causal): the loss to 1e-5 and
    every leaf's gradient to 2e-4 of its max |g|."""
    jc = jax_cfg(ENCODER).replace(compute_dtype="float32")
    tc = get_smoke_config(ENCODER).replace(compute_dtype="float32")
    jp = jax.device_get(jax_init(jax.random.PRNGKey(0), jc,
                                 JPlan(remat=False)))
    rng = np.random.default_rng(5)
    batch = {"embeds": rng.standard_normal((4, 197, jc.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, jc.vocab_size, (4,)).astype(np.int32)}
    jl, _, jg = _jax_value_and_grad(jc, jp, batch)
    loss, _, grads = _port_value_and_grad(tc, jp, batch, BuildPlan())
    assert loss == pytest.approx(jl, rel=1e-5)
    _check_grads(grads, _port_tree(jg), False, ENCODER)
