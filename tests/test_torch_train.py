"""Training steps, the port against the JAX package from seeded numpy
inputs and the same (JAX-initialized) weights: `lm_loss` and its
gradients on the three dense smoke configs, `make_train_step` over 3
steps at 1 and 4 microbatches and under int8_ef compression (a gloo
world of one). The Trainer, checkpoints and JAX's loop-level tests are
tests/test_torch_trainer.py.

Tolerances. At f32 compute the two packages do the same arithmetic in
other orders: losses agree to 1e-5 (relative), lm_loss gradients to 2e-4
of each leaf's max |g| (the random init's gradients reach |g| ~ 5). A train step takes its gradients w.r.t. a bf16
copy of the params, in both packages, so the backward accumulates each
gradient leaf in bf16, in another order in each package (the embedding's
scatter-add most of all): a leaf is held to one bf16 ulp of its largest
entry (|Δ| ≤ 2^-8·max|g|; measured up to 2.2e-3·max|g|). Adam's first step is
±lr wherever |g| is tiny, so a sign flip moves a param by 2·lr: post-step
params are held to 2·lr a step. At bf16 compute the JAX attention rounds
P to bf16 before P·V and the port's keeps f32 (ROADMAP Queue C, "bf16
rounding sites"): losses there agree to 1e-2 (relative).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_smoke_config as jax_cfg
from repro.configs.base import RunConfig as JRunConfig
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models import lm_loss as jlm_loss
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.train_step import init_train_state as jinit_state
from repro.train.train_step import make_train_step as jmake_step
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_numpy, train_state_to_numpy
from repro_torch.data import SyntheticLM
from repro_torch.models import BuildPlan, lm_loss
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.train_step import _loss_and_grads

torch.set_num_threads(2)

DENSE = ["qwen2-7b", "mistral-large-123b", "h2o-danube-1.8b"]
BF16_ULP = 2.0 ** -8      # one bf16 ulp of a value's binade, relative


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg(arch),
                                   JPlan(remat=False)))


def _cfgs(arch, cd="float32"):
    return (jax_cfg(arch).replace(compute_dtype=cd),
            get_smoke_config(arch).replace(compute_dtype=cd))


def _batch(vocab, B, T, step):
    return SyntheticLM(vocab, seed=0).sample(B, T, step)


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_tree(jtree):
    """A JAX params-shaped tree (numpy) in the port's layout."""
    return params_from_numpy(jax.device_get(jtree), "cpu")


def _leaves(tree):
    return pytree.tree_flatten(tree)[0]


def _check_grads(got, want, bf16_rounded, what=""):
    """Per leaf: |Δ| ≤ 2e-4·max|g|, or one bf16 ulp of the leaf's largest
    entry (2^-8·max|g|) where both sides accumulated it in bf16."""
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in pytree.tree_flatten_with_path(want)[0]]
    for name, a, b in zip(names, _leaves(got), _leaves(want)):
        a, b = a.detach().float().numpy(), b.detach().float().numpy()
        assert a.shape == b.shape, (what, name)
        top = float(np.abs(b).max())
        bound = (BF16_ULP if bf16_rounded else 2e-4) * top
        assert (np.abs(a - b) <= bound + 1e-12).all(), (
            what, name, float(np.abs(a - b).max()), top)


# ---------------------------------------------------------------------------
# lm_loss and its gradient against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_f32_grads_match_jax(arch):
    """f32 compute, the JAX init: the loss to 1e-5 and every leaf's
    gradient to 2e-4 of its max |g| (h2o-danube: its sliding window; the
    port's default plan rematerializes each layer, JAX's here does not)."""
    jc, tc = _cfgs(arch)
    jp = _jparams(arch)
    batch = _batch(jc.vocab_size, 4, 40, 3)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jc, JPlan(remat=False),
                           {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, jp))
    tp = params_from_numpy(jp, "cpu")
    leaves = [t.requires_grad_(True) for t in _leaves(tp)]
    loss, aux = lm_loss(tp, tc, BuildPlan(), _as_torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["z_loss"].detach()) == pytest.approx(
        float(jaux["z_loss"]), rel=1e-4)
    _check_grads(pytree.tree_unflatten(list(grads),
                                       pytree.tree_structure(tp)),
                 _port_tree(jg), False, arch)


def test_lm_loss_row_max_is_a_constant_of_the_gradient():
    """JAX stops the gradient of the row max: with a tie at the max the
    gradient is JAX's (softmax − onehot), not split across the tie."""
    jc, tc = _cfgs("qwen2-7b")
    logits = np.zeros((1, 1, 4), np.float32)
    logits[..., :2] = 3.0                                  # a tie
    x = torch.from_numpy(logits).requires_grad_(True)
    m = x.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]
    (lse.sum()).backward()
    want = np.exp(logits - np.log(np.exp(logits).sum(-1, keepdims=True)))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-7b", "hymba-1.5b",
                                  "granite-moe-3b-a800m", "rwkv6-7b"])
def test_remat_is_checkpointing_under_grad_and_free_without(monkeypatch,
                                                             arch):
    """BuildPlan.remat: every layer body runs under torch.utils.checkpoint
    when autograd records (the gradients equal remat=False's bit for bit:
    the recomputed layer is the layer, hymba's selective scan, the MoE
    routing and the wkv included), and never under torch.no_grad."""
    import torch.utils.checkpoint as ckpt_mod
    _, tc = _cfgs(arch)
    tp = params_from_numpy(_jparams(arch), "cpu")
    batch = _as_torch(_batch(tc.vocab_size, 2, 24, 0))
    calls = []
    real = ckpt_mod.checkpoint
    monkeypatch.setattr(ckpt_mod, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    grads = {}
    for remat in (True, False):
        leaves = [t.detach().requires_grad_(True) for t in _leaves(tp)]
        p = pytree.tree_unflatten(leaves, pytree.tree_structure(tp))
        loss, _ = lm_loss(p, tc, BuildPlan(remat=remat), batch)
        grads[remat] = torch.autograd.grad(loss, leaves)
    assert len(calls) == tc.n_layers
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    with torch.no_grad():
        lm_loss(tp, tc, BuildPlan(remat=True), batch)
    assert len(calls) == tc.n_layers


# ---------------------------------------------------------------------------
# make_train_step against JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_grad_fn(jc):
    return jax.jit(jax.grad(lambda p, mb: jlm_loss(p, jc, JPlan(remat=False),
                                                   mb), has_aux=True))


def _jax_pre_clip_grads(jparams, jc, batch, nm):
    """JAX's step's gradient before clipping: value_and_grad of lm_loss
    w.r.t. the bf16 cast, f32-accumulated over nm microbatches, / nm."""
    cast = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                  jparams)
    gacc = None
    B = batch["tokens"].shape[0]
    for i in range(nm):
        mb = {k: jnp.asarray(v[i * B // nm:(i + 1) * B // nm])
              for k, v in batch.items()}
        g, _ = _jax_grad_fn(jc)(cast, mb)
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
        gacc = g if gacc is None else jax.tree_util.tree_map(jnp.add, gacc,
                                                             g)
    return jax.tree_util.tree_map(lambda x: x / nm, gacc)


@pytest.mark.parametrize("nm", [1, 4])
def test_train_step_matches_jax(nm):
    """Three steps from the JAX init at f32 compute: each step's loss,
    pre-clip grad norm and lr, each step's pre-clip gradients leaf by leaf
    (both packages from the port's params of that step), and the params
    after 3 steps (2·lr a step)."""
    arch = "qwen2-7b"
    jc, tc = _cfgs(arch)
    rc = dict(arch=arch, microbatches=nm, learning_rate=1e-3,
              warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_step(jc, JPlan(remat=False), JRunConfig(**rc),
                               JAdamWConfig()))
    tstep = make_train_step(tc, BuildPlan(), RunConfig(**rc), AdamWConfig())
    jp = _jparams(arch)
    jstate = jinit_state(jax.tree_util.tree_map(jnp.asarray, jp),
                         JAdamWConfig())
    tstate = init_train_state(params_from_numpy(jp, "cpu"), AdamWConfig())
    for i in range(3):
        batch = _batch(jc.vocab_size, 8, 32, i)
        # both packages' gradients from the port's current params (the
        # params themselves drift apart by Adam's ±lr steps)
        loss, grads = _loss_and_grads(tc, BuildPlan(), nm, tstate["params"],
                                      _as_torch(batch))
        now = train_state_to_numpy(tstate)["params"]
        _check_grads(grads, _port_tree(_jax_pre_clip_grads(
            now, jc, batch, nm)), True, f"nm={nm} step {i}")
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _as_torch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4), i
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    for a, b in zip(_leaves(tstate["params"]),
                    _leaves(_port_tree(jstate["params"]))):
        assert float((a - b).abs().max()) <= 2 * 1e-3 * 3 + 1e-6


def test_train_step_bf16_losses_match_jax():
    """The smoke config's own bf16 compute over three steps: losses agree
    to 1e-2 (the bf16 rounding sites differ, module docstring)."""
    arch = "mistral-large-123b"
    jc, tc = _cfgs(arch, "bfloat16")
    rc = dict(arch=arch, learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_step(jc, JPlan(remat=False), JRunConfig(**rc),
                               JAdamWConfig()))
    tstep = make_train_step(tc, BuildPlan(), RunConfig(**rc), AdamWConfig())
    jp = _jparams(arch)
    jstate = jinit_state(jax.tree_util.tree_map(jnp.asarray, jp),
                         JAdamWConfig())
    tstate = init_train_state(params_from_numpy(jp, "cpu"), AdamWConfig())
    for i in range(3):
        batch = _batch(jc.vocab_size, 8, 32, i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _as_torch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-2), i


@pytest.fixture
def world_of_one():
    from repro_torch import dist as rd
    dev, started = rd.init_world("gloo", "cpu")
    yield dev
    rd.close_world(started)


def test_train_step_int8_ef_matches_jax(world_of_one, monkeypatch):
    """grad_compression="int8_ef" over a gloo world of one against JAX's
    step under a 1-shard shard_map, three steps. Each step: the loss (1e-5)
    and the clipped norm of the all-reduced gradient (1e-4); the
    all-reduced gradient the step applies and its new residual, leaf by
    leaf, against JAX's compressed_psum of JAX's gradient and residual on
    the grid of the JAX leaf (its per-layer leaves share the stacked
    leaf's absmax scale s). A gradient a bf16 ulp apart takes the other
    code where it sits near a rounding boundary: codes may differ in at
    most 0.2% of the entries (measured ≤ 0.05%), each by at most one grid
    step for every step so far (the carried residual keeps an earlier
    flip), |Δ| ≤ (step + 1)·s. The params after 3 steps (2·lr a step);
    the refusals."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    import repro_torch.dist.collectives as tcol
    from repro.dist import data_mesh
    from repro.dist.collectives import compressed_psum
    from repro_torch.train.train_step import stacked_grids
    arch = "qwen2-7b"
    jc, tc = _cfgs(arch)
    rc = dict(arch=arch, learning_rate=1e-3, warmup_steps=1, total_steps=10,
              grad_compression="int8_ef")
    with pytest.raises(ValueError, match="process group"):
        make_train_step(tc, BuildPlan(), RunConfig(**rc), AdamWConfig())
    with pytest.raises(ValueError, match="unknown grad_compression"):
        make_train_step(tc, BuildPlan(),
                        RunConfig(**{**rc, "grad_compression": "fp8"}),
                        AdamWConfig())
    one_shard = dict(mesh=data_mesh(1), out_specs=(P(), P()),
                     check_rep=False)
    jstep = jax.jit(shard_map(
        jmake_step(jc, JPlan(remat=False), JRunConfig(**rc), JAdamWConfig(),
                   axis_name="data"), in_specs=(P(), P("data")),
        **one_shard))
    jreduce = jax.jit(shard_map(
        lambda g, e: compressed_psum(g, "data", e, 1), in_specs=(P(), P()),
        **one_shard))
    tstep = make_train_step(tc, BuildPlan(), RunConfig(**rc), AdamWConfig(),
                            group="world")
    jp = _jparams(arch)
    jstate = jinit_state(jax.tree_util.tree_map(jnp.asarray, jp),
                         JAdamWConfig(), JRunConfig(**rc))
    tstate = init_train_state(params_from_numpy(jp, "cpu"), AdamWConfig(),
                              RunConfig(**rc))
    assert set(tstate) == {"params", "opt", "grad_err"}
    seen = []
    real = tcol.compressed_all_reduce

    def recording(*a, **k):
        out, err = real(*a, **k)
        seen.append([[t.clone() for t in _leaves(x)] for x in (out, err)])
        return out, err

    monkeypatch.setattr(tcol, "compressed_all_reduce", recording)
    keys = stacked_grids(tstate["params"])
    for i in range(3):
        batch = _batch(jc.vocab_size, 4, 32, i)
        jg = _jax_pre_clip_grads(jax.device_get(jstate["params"]), jc,
                                 batch, 1)
        want = [_leaves(_port_tree(x))
                for x in jreduce(jg, jstate["grad_err"])]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _as_torch(batch))
        assert len(seen) == i + 1
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4), i
        amax = {}
        for k, o, e in zip(keys, *want):
            amax[k] = max(amax.get(k, 0.0), float((o + e).abs().max()))
        for what, got, ref in zip(("reduced gradient", "residual"),
                                  seen[-1], want):
            flips = total = 0
            for k, a, b in zip(keys, got, ref):
                s = max(amax[k] / 127.0, 1e-30)
                d = (a - b).abs()
                assert float(d.max()) <= (i + 1) * s * (1 + 1e-5), (
                    i, what, k, float(d.max()) / s)
                flips += int((d > s / 2).sum())
                total += d.numel()
            assert flips <= 2e-3 * total, (i, what, flips, total)
    for e, je in zip(_leaves(tstate["grad_err"]), seen[-1][1]):
        assert torch.equal(e, je)           # the state carries the residual
    for a, b in zip(_leaves(tstate["params"]),
                    _leaves(_port_tree(jstate["params"]))):
        assert float((a - b).abs().max()) <= 2 * 1e-3 * 3 + 1e-6
