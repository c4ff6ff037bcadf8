"""Training the non-dense families that JAX's Trainer feeds (deepseek-67b,
the MoE pair, hymba, rwkv6, musicgen), the port against the JAX package
from the same (JAX-initialized) weights and seeded batches:
`make_train_step` over 3 steps (granite also at 4 microbatches), a short
`Trainer` run against JAX's loop, train states converted both ways, and
checkpoints that each package's Trainer resumes from the other's
(granite, hymba); then `launch.train` on each family, and its refusal of
the VLM and the encoder. `lm_loss` gradients are
tests/test_torch_train_families.py.

Bounds are the dense tests' (tests/test_torch_train.py,
tests/test_torch_trainer.py): a step's pre-clip gradient leaf within one
bf16 ulp of its max, params within 2·lr a step, a Trainer's losses within
DESCENT_TOL of JAX's a step, a resumed step's loss to 1e-4. The ulp is
the bf16 spacing at the leaf's max, 2^(⌊log2 max⌋ − 7): between 2^-8 and
2^-7 of the max (the dense helper's 2^-8·max is its lower end). Every
leaf measured off by more than 2^-8·max here was off by exactly that one
ulp (deepseek's embed 0.015625 at max 3.83; granite's embed 0.03125 at
4.81), where both packages' bf16 gradients lie 10-160 ulps from the f32
gradient.
"""
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs.base import RunConfig as JRunConfig
from repro.models import BuildPlan as JPlan
from repro.models import lm_loss as jlm_loss
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.train_step import init_train_state as jinit_state
from repro.train.train_step import make_train_step as jmake_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch.ckpt import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import (params_from_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.models import BuildPlan
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.train_step import _loss_and_grads
from test_torch_train import (_as_torch, _batch, _cfgs, _jparams, _leaves,
                              _port_tree)
from test_torch_trainer import DESCENT_TOL, _FromJaxInit

torch.set_num_threads(2)

TRAINER_FAMILIES = ["deepseek-67b", "granite-moe-3b-a800m",
                    "llama4-maverick-400b-a17b", "hymba-1.5b", "rwkv6-7b",
                    "musicgen-large"]
GRANITE, HYMBA = "granite-moe-3b-a800m", "hymba-1.5b"
STATE_FAMILIES = [GRANITE, HYMBA, "rwkv6-7b", "musicgen-large"]
LR = 1e-3


def _check_grads_ulp(got, want, what):
    """Per leaf: |Δ| ≤ one bf16 ulp at the leaf's max |g| (module
    docstring)."""
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in pytree.tree_flatten_with_path(want)[0]]
    for name, a, b in zip(names, _leaves(got), _leaves(want)):
        a, b = a.detach().float().numpy(), b.detach().float().numpy()
        assert a.shape == b.shape, (what, name)
        top = float(np.abs(b).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        assert (np.abs(a - b) <= ulp).all(), (
            what, name, float(np.abs(a - b).max()), top, ulp)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad_fn(jc):
    return jax.jit(jax.value_and_grad(
        lambda p, mb: jlm_loss(p, jc, JPlan(remat=False), mb)[0]))


def _jax_step_loss_and_grads(jparams, jc, batch, nm):
    """JAX's step's loss and pre-clip gradient at `jparams` (numpy):
    value_and_grad of lm_loss w.r.t. the bf16 cast, f32-accumulated over
    nm microbatches, / nm (test_torch_train._jax_pre_clip_grads with the
    loss)."""
    cast = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                  jparams)
    gacc, losses = None, []
    B = batch["tokens"].shape[0]
    for i in range(nm):
        mb = {k: jnp.asarray(v[i * B // nm:(i + 1) * B // nm])
              for k, v in batch.items()}
        loss, g = _jax_value_and_grad_fn(jc)(cast, mb)
        losses.append(float(loss))
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
        gacc = g if gacc is None else jax.tree_util.tree_map(jnp.add, gacc,
                                                             g)
    return (float(np.mean(losses)),
            jax.device_get(jax.tree_util.tree_map(lambda x: x / nm, gacc)))


def _norm(tree):
    return float(torch.sqrt(sum((t.double() ** 2).sum()
                                for t in _leaves(tree))))


# ---------------------------------------------------------------------------
# make_train_step against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,nm", [(a, 1) for a in TRAINER_FAMILIES]
                         + [(GRANITE, 4)])
def test_train_step_matches_jax(arch, nm):
    """Three steps from the JAX init at f32 compute, as the dense test:
    each step's loss (1e-5), its pre-clip gradients leaf by leaf (one bf16
    ulp of the leaf's max) and their global norm (1e-4), both packages
    from the port's params of that step; the first step's loss and grad
    norm against JAX's step's, from the same params (later steps start
    from params Adam's ±lr has moved apart: granite's step-2 loss moves
    1.2e-5 with them, with 0 of its 1024 (token, expert) pairs routed or
    dropped otherwise in either package, and 8e-8 between the packages at
    the same params); the lr and step; the params after 3 steps (2·lr a
    step)."""
    jc, tc = _cfgs(arch)
    rc = dict(arch=arch, microbatches=nm, learning_rate=LR, warmup_steps=1,
              total_steps=10)
    jstep = jax.jit(jmake_step(jc, JPlan(remat=False), JRunConfig(**rc),
                               JAdamWConfig()))
    tstep = make_train_step(tc, BuildPlan(), RunConfig(**rc), AdamWConfig())
    jp = _jparams(arch)
    jstate = jinit_state(jax.tree_util.tree_map(jnp.asarray, jp),
                         JAdamWConfig())
    tstate = init_train_state(params_from_numpy(jp, "cpu"), AdamWConfig())
    for i in range(3):
        batch = _batch(jc.vocab_size, 8, 32, i)
        _, grads = _loss_and_grads(tc, BuildPlan(), nm, tstate["params"],
                                   _as_torch(batch))
        now = train_state_to_numpy(tstate)["params"]
        jloss, jgrads = _jax_step_loss_and_grads(now, jc, batch, nm)
        jgrads = _port_tree(jgrads)
        _check_grads_ulp(grads, jgrads, f"{arch} nm={nm} step {i}")
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _as_torch(batch))
        assert float(tm["loss"]) == pytest.approx(jloss, rel=1e-5), i
        assert float(tm["grad_norm"]) == pytest.approx(_norm(jgrads),
                                                       rel=1e-4), i
        if i == 0:
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-4)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    for a, b in zip(_leaves(tstate["params"]),
                    _leaves(_port_tree(jstate["params"]))):
        assert float((a - b).abs().max()) <= 2 * LR * 3 + 1e-6


# ---------------------------------------------------------------------------
# the Trainer against JAX's, train states and checkpoints across packages
# ---------------------------------------------------------------------------

def _run_cfg(ckpt_dir, arch, **kw):
    base = dict(arch=arch, ckpt_dir=str(ckpt_dir), ckpt_every=100,
                total_steps=10, learning_rate=3e-3, warmup_steps=2,
                async_ckpt=False)
    base.update(kw)
    return base


@pytest.mark.parametrize("arch", TRAINER_FAMILIES)
def test_trainer_tracks_jax(tmp_path, arch):
    """Each package's Trainer, from the same init, 6 steps of 4 x 32 at
    the smoke config's own compute: every loss finite and within
    DESCENT_TOL of JAX's step (the 30-step curve's bound), and the steps
    numbered as JAX's."""
    jc, tc = _cfgs(arch, get_smoke_config(arch).compute_dtype)
    ref = JTrainer(jc, JPlan(remat=False),
                   JRunConfig(**_run_cfg(tmp_path / "j", arch))).run_loop(
        total_steps=6, seq_len=32, global_batch=4)
    out = _FromJaxInit(tc, BuildPlan(remat=False),
                       RunConfig(**_run_cfg(tmp_path / "t", arch)),
                       device="cpu").run_loop(total_steps=6, seq_len=32,
                                              global_batch=4)
    losses = [m["loss"] for m in out["metrics"]]
    want = [m["loss"] for m in ref["metrics"]]
    assert len(losses) == len(want) == 6
    assert all(np.isfinite(losses)), losses
    gap = max(abs(a - b) for a, b in zip(losses, want))
    assert gap <= DESCENT_TOL, (gap, losses, want)
    assert [m["step"] for m in out["metrics"]] == list(range(1, 7))


@pytest.mark.parametrize("arch", STATE_FAMILIES)
def test_train_state_converts_both_ways(arch):
    """A JAX train state (int8 moments, int8_ef's grad_err) of the MoE,
    hybrid, RWKV and audio families -> the port's -> the JAX layout again,
    every leaf equal with its dtype (the checkpoint layout)."""
    rc = JRunConfig(arch=arch, grad_compression="int8_ef")
    js = jax.device_get(jax.jit(lambda p: jinit_state(
        p, JAdamWConfig(moment_dtype="int8"), rc))(
            jax.tree_util.tree_map(jnp.asarray, _jparams(arch))))
    ts = train_state_from_numpy(js, "cpu")
    assert isinstance(ts["params"]["layers"], list)
    assert len(ts["params"]["layers"]) == _cfgs(arch)[1].n_layers
    flat = flatten_with_paths(train_state_to_numpy(ts))
    jflat = jax.tree_util.tree_flatten_with_path(js)[0]
    assert len(flat) == len(jflat)
    for path, leaf in jflat:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        assert flat[key].dtype == np.asarray(leaf).dtype, key
        assert np.array_equal(flat[key], np.asarray(leaf)), key


@pytest.mark.parametrize("arch", [GRANITE, HYMBA])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, arch, writer):
    """One package's Trainer runs 3 steps with a checkpoint at step 2 (f32
    compute); the other's resumes that checkpoint, and its step 3 loss
    equals the first run's to 1e-4."""
    jc, tc = _cfgs(arch)

    def jax_run(**kw):
        return JTrainer(jc, JPlan(remat=False),
                        JRunConfig(**_run_cfg(tmp_path, arch, **kw))
                        ).run_loop(3, 32, 4)

    def port_run(**kw):
        return _FromJaxInit(tc, BuildPlan(),
                            RunConfig(**_run_cfg(tmp_path, arch, **kw)),
                            device="cpu").run_loop(3, 32, 4)

    first, second = (jax_run, port_run) if writer == "jax" else \
        (port_run, jax_run)
    ref = first(ckpt_every=2)
    shutil.rmtree(tmp_path / "step_3")          # the run's final save
    out = second()
    assert out["final_step"] == 3 and len(out["metrics"]) == 1
    assert out["metrics"][0]["loss"] == pytest.approx(
        ref["metrics"][2]["loss"], rel=1e-4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TRAINER_FAMILIES)
def test_launcher_trains_each_family(tmp_path, capsys, arch):
    """launch.train --arch <family> --smoke on the CPU: JAX's final line,
    finite losses, the steps run."""
    from repro_torch.launch import train
    line = train.main(["--arch", arch, "--smoke", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line and line["arch"] == f"{arch}-smoke"
    assert line["steps"] == 2
    assert np.isfinite([line["first_loss"], line["last_loss"]]).all()


@pytest.mark.parametrize("arch,needs", [
    ("llama-3.2-vision-90b", "vision_embeds"),
    ("vit-base-16", "embeds'] .* and batch\\['labels")])
def test_launcher_refuses_the_vlm_and_the_encoder(tmp_path, capsys, arch,
                                                  needs):
    """The VLM and the encoder: exit 1 with a message naming the inputs
    their lm_loss reads and token batches lack, before any training."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match=needs) as e:
        train.main(["--arch", arch, "--smoke", "--steps", "2", "--ckpt-dir",
                    str(tmp_path), "--device", "cpu"])
    assert isinstance(e.value.code, str)          # printed, exit status 1
    assert not list(tmp_path.iterdir())
