"""Training loops, the port against the JAX package from seeded numpy
inputs and the same (JAX-initialized) weights: train states converted
both ways, checkpoints that each package's Trainer resumes from the
other's, and the 30-step loss curve of JAX's test_loss_decreases_end_to_end
through both Trainers; then JAX's tests/test_train.py,
test_fault_tolerance.py (crash / restart) and test_system.py (train, then
COMQ beats RTN at 3 bits, then serve), run on the port. The step-level
parity (lm_loss gradients, make_train_step) is tests/test_torch_train.py.
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
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.train_step import init_train_state as jinit_state
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import (params_from_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import SyntheticLM
from repro_torch.models import BuildPlan, init_params, lm_loss
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, init_train_state, make_train_step

torch.set_num_threads(2)

torch.set_num_threads(2)


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


def _leaves(tree):
    return pytree.tree_flatten(tree)[0]


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _run_cfg(ckpt_dir, **kw):
    base = dict(arch="qwen2-7b", ckpt_dir=str(ckpt_dir), ckpt_every=100,
                total_steps=10, learning_rate=1e-3, warmup_steps=2,
                async_ckpt=False)
    base.update(kw)
    return base


def test_train_state_converts_both_ways():
    """A JAX train state with int8 moments and grad_err -> the port's ->
    the JAX layout again, every leaf equal (the checkpoint layout)."""
    jp = _jparams("qwen2-7b")
    rc = JRunConfig(arch="q", grad_compression="int8_ef")
    js = jax.device_get(jax.jit(lambda p: jinit_state(
        p, JAdamWConfig(moment_dtype="int8"), rc))(
            jax.tree_util.tree_map(jnp.asarray, jp)))
    ts = train_state_from_numpy(js, "cpu")
    assert isinstance(ts["params"]["layers"], list)
    assert set(ts["opt"]["m"]["layers"][0]["attn"]["wq"]) == {"q", "scale",
                                                              "ef"}
    back = train_state_to_numpy(ts)
    jflat = jax.tree_util.tree_flatten_with_path(js)[0]
    from repro_torch.ckpt import flatten_with_paths
    flat = flatten_with_paths(back)
    assert len(flat) == len(jflat)
    for path, leaf in jflat:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        assert flat[key].dtype == np.asarray(leaf).dtype, key
        assert np.array_equal(flat[key], np.asarray(leaf)), key


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_jax_checkpoint_resumes_in_the_port_trainer(tmp_path, moment_dtype):
    """JAX's Trainer runs 3 steps with a checkpoint at step 2; the port's
    Trainer resumes that checkpoint and its step 3 loss equals the JAX
    run's to 1e-4 (f32 compute)."""
    import shutil

    from repro.train.trainer import Trainer as JTrainer
    jc, tc = _cfgs("qwen2-7b")
    acfg = dict(moment_dtype=moment_dtype)
    ref = JTrainer(jc, JPlan(remat=False),
                   JRunConfig(**_run_cfg(tmp_path, ckpt_every=2)),
                   adamw_cfg=JAdamWConfig(**acfg)).run_loop(3, 32, 4)
    shutil.rmtree(tmp_path / "step_3")          # the run's final save
    t = Trainer(tc, BuildPlan(), RunConfig(**_run_cfg(tmp_path)),
                adamw_cfg=AdamWConfig(**acfg), device="cpu")
    out = t.run_loop(3, 32, 4)
    assert out["final_step"] == 3 and len(out["metrics"]) == 1
    assert out["metrics"][0]["loss"] == pytest.approx(
        ref["metrics"][2]["loss"], rel=1e-4)


def test_port_checkpoint_resumes_in_the_jax_trainer(tmp_path):
    """The reverse: the port's Trainer runs 3 steps with a checkpoint at
    step 2, JAX's resumes that checkpoint, and its step 3 loss equals the
    port run's to 1e-4."""
    import shutil

    from repro.train.trainer import Trainer as JTrainer
    jc, tc = _cfgs("qwen2-7b")
    ref = Trainer(tc, BuildPlan(), RunConfig(**_run_cfg(tmp_path,
                                                        ckpt_every=2)),
                  device="cpu").run_loop(3, 32, 4)
    shutil.rmtree(tmp_path / "step_3")          # the run's final save
    out = JTrainer(jc, JPlan(remat=False),
                   JRunConfig(**_run_cfg(tmp_path))).run_loop(3, 32, 4)
    assert out["final_step"] == 3 and len(out["metrics"]) == 1
    assert out["metrics"][0]["loss"] == pytest.approx(
        ref["metrics"][2]["loss"], rel=1e-4)


# ---------------------------------------------------------------------------
# JAX's tests/test_train.py, test_fault_tolerance.py and test_system.py on
# the port
# ---------------------------------------------------------------------------

class _FromJaxInit(Trainer):
    """The port's Trainer started from the JAX Trainer's initial params
    (the same PRNGKey(seed) init, converted)."""

    def init_state(self):
        return init_train_state(
            params_from_numpy(_jparams(self.cfg.name.replace("-smoke", "")),
                              self.device), self.adamw_cfg, self.run)


# the 30-step curves against JAX's: any step's |port − JAX| loss, and that
# of the mean of the last 5 (measured 0.068 and 0.0097; the port at f32
# compute lands as far from JAX's bf16 curve, 0.061: a rounding-level
# change moves this trajectory by ~0.06, Adam's ±lr first steps on tiny
# gradients most of all)
DESCENT_TOL, DESCENT_TAIL_TOL = 0.15, 0.05


def test_loss_decreases_end_to_end_and_tracks_jax(tmp_path):
    """JAX's test_loss_decreases_end_to_end (tests/test_train.py:23's
    settings: the qwen2 smoke config at its bf16 compute, lr 3e-3, warmup
    5, 30 steps of 8 x 64) through both packages' Trainers from the same
    init: each step's loss within DESCENT_TOL of JAX's and the mean of the
    last 5 within DESCENT_TAIL_TOL, and the port's last loss below its
    first by 0.5 (JAX's gate)."""
    from repro.train.trainer import Trainer as JTrainer
    cfg = get_smoke_config("qwen2-7b")
    kw = dict(arch="qwen2-7b", ckpt_every=100, total_steps=30,
              learning_rate=3e-3, warmup_steps=5, async_ckpt=False)
    ref = JTrainer(jax_cfg("qwen2-7b"), JPlan(remat=False),
                   JRunConfig(ckpt_dir=str(tmp_path / "j"), **kw)).run_loop(
        total_steps=30, seq_len=64, global_batch=8)
    t = _FromJaxInit(cfg, BuildPlan(remat=False),
                     RunConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                     device="cpu")
    out = t.run_loop(total_steps=30, seq_len=64, global_batch=8)
    losses = [m["loss"] for m in out["metrics"]]
    want = [m["loss"] for m in ref["metrics"]]
    gap = max(abs(a - b) for a, b in zip(losses, want))
    assert len(losses) == len(want) == 30
    assert gap <= DESCENT_TOL, (gap, losses, want)
    assert abs(np.mean(losses[-5:]) - np.mean(want[-5:])) <= \
        DESCENT_TAIL_TOL, (losses[-5:], want[-5:])
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]
    assert all(m["step"] == i + 1 for i, m in enumerate(out["metrics"]))
    assert set(out["metrics"][0]) >= {"loss", "grad_norm", "lr", "step"}


def test_init_and_step_leave_the_callers_params():
    """init_train_state takes its own copy: neither it nor a step (which
    updates the state it owns in place) changes the caller's tensors."""
    cfg = get_smoke_config("qwen2-7b")
    params = init_params(cfg, seed=0, device="cpu")
    before = [t.clone() for t in _leaves(params)]
    state = init_train_state(params, AdamWConfig())
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(_leaves(params), _leaves(state["params"])))
    step = make_train_step(cfg, BuildPlan(remat=False),
                           RunConfig(arch="q", learning_rate=1e-2,
                                     warmup_steps=0, total_steps=5),
                           AdamWConfig())
    new_state, _ = step(state, _as_torch(_batch(cfg.vocab_size, 2, 16, 0)))
    assert any(not torch.equal(a, b) for a, b in
               zip(_leaves(new_state["params"]), before))
    for a, b in zip(_leaves(params), before):
        assert torch.equal(a, b)


def test_microbatch_accumulation_equivalence():
    """nm=1 and nm=4 produce (numerically) the same update."""
    cfg = get_smoke_config("mistral-large-123b")
    params = init_params(cfg, seed=0, device="cpu")
    rs = np.random.RandomState(1)
    batch = {"tokens": torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                   (8, 32))),
             "labels": torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                   (8, 32)))}
    outs = []
    for nm in (1, 4):
        run_cfg = RunConfig(arch="m", microbatches=nm, learning_rate=1e-3,
                            warmup_steps=1, total_steps=10)
        step = make_train_step(cfg, BuildPlan(remat=False), run_cfg,
                               AdamWConfig())
        outs.append(step(init_train_state(params, AdamWConfig()), batch)[0])
    for a, b in zip(_leaves(outs[0]["params"]), _leaves(outs[1]["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-4)


def test_train_crash_restart_resumes(tmp_path):
    """Kill the trainer at step 7; the restart resumes from the step-5
    checkpoint and finishes, and its losses from step 6 on equal an
    uninterrupted run's bit for bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ft import run_with_restarts
    cfg = get_smoke_config("qwen2-7b")
    kw = dict(arch="qwen2-7b", ckpt_every=5, total_steps=12,
              async_ckpt=False, learning_rate=1e-3, warmup_steps=2)
    crashed = {"done": False}
    history = []

    def bomb(step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    def attempt(resume_step):
        t = Trainer(cfg, BuildPlan(remat=False),
                    RunConfig(ckpt_dir=str(tmp_path / "k"), **kw),
                    failure_hook=bomb, device="cpu")
        try:
            return t.run_loop(total_steps=12, seq_len=32,
                              global_batch=4)["final_step"]
        finally:
            history.append([m["loss"] for m in t.metrics_log])

    def latest():
        return CheckpointManager(str(tmp_path / "k")).latest_step()

    assert run_with_restarts(attempt, latest, max_restarts=2) == 12
    assert crashed["done"] and latest() == 12
    ref = Trainer(cfg, BuildPlan(remat=False),
                  RunConfig(ckpt_dir=str(tmp_path / "r"), **kw),
                  device="cpu").run_loop(12, 32, 4)
    losses = [m["loss"] for m in ref["metrics"]]
    assert history[0] == losses[:7] and history[1] == losses[5:]


def test_trainer_refuses_shard_state_fn(tmp_path):
    with pytest.raises(NotImplementedError, match="restore"):
        Trainer(get_smoke_config("qwen2-7b"), BuildPlan(),
                RunConfig(arch="q", ckpt_dir=str(tmp_path)),
                shard_state_fn=lambda s: None, device="cpu")


def test_trainer_runs_with_int8_ef_and_moments(tmp_path):
    """int8_ef in a Trainer: it starts (and ends) a world of one, threads
    grad_err through the state and its checkpoint; int8 moments ride the
    same checkpoint and a second Trainer resumes it."""
    import torch.distributed as dist
    cfg = get_smoke_config("qwen2-7b")
    run_cfg = RunConfig(arch="qwen2-7b", ckpt_dir=str(tmp_path),
                        ckpt_every=2, total_steps=3, learning_rate=1e-3,
                        warmup_steps=1, async_ckpt=False,
                        grad_compression="int8_ef")
    acfg = AdamWConfig(moment_dtype="int8")
    t = Trainer(cfg, BuildPlan(remat=False), run_cfg, adamw_cfg=acfg,
                device="cpu")
    out = t.run_loop(total_steps=3, seq_len=32, global_batch=4)
    assert out["final_step"] == 3 and not dist.is_initialized()
    errs = _leaves(out["state"]["grad_err"])
    assert any(float(e.abs().max()) > 0 for e in errs)
    again = Trainer(cfg, BuildPlan(remat=False), run_cfg, adamw_cfg=acfg,
                    device="cpu")
    state, start = again.resume_or_init()
    assert start == 3
    for a, b in zip(_leaves(state), _leaves(out["state"])):
        assert torch.equal(a, b)


def test_launcher_prints_the_jax_summary(tmp_path, capsys):
    import json

    from repro_torch.launch import train
    line = train.main(["--arch", "qwen2-7b", "--smoke", "--steps", "3",
                       "--batch", "4", "--seq", "16", "--ckpt-dir",
                       str(tmp_path), "--device", "cpu", "--remat"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"arch", "steps", "first_loss", "last_loss",
                         "stragglers"}
    assert line["steps"] == 3 and line["arch"] == "qwen2-7b-smoke"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = get_smoke_config("h2o-danube-1.8b")
    run_cfg = RunConfig(arch="h2o-danube-1.8b",
                        ckpt_dir=str(tmp_path_factory.mktemp("ck")),
                        ckpt_every=1000, total_steps=60, learning_rate=3e-3,
                        warmup_steps=5, async_ckpt=False)
    t = Trainer(cfg, BuildPlan(remat=False), run_cfg, device="cpu")
    out = t.run_loop(total_steps=60, seq_len=64, global_batch=8)
    return cfg, out["state"]["params"], out["metrics"]


def _eval_loss(params, cfg):
    data = SyntheticLM(cfg.vocab_size, seed=0).sample(8, 64, step=9999)
    with torch.no_grad():
        return float(lm_loss(params, cfg, BuildPlan(), _as_torch(data))[0])


def test_training_learned_structure(trained):
    _, _, metrics = trained
    assert metrics[-1]["loss"] < metrics[0]["loss"] - 0.8


def test_comq_beats_rtn_on_trained_model_and_serves(trained):
    """At 3 bits COMQ keeps the trained model's eval loss at least as well
    as RTN on the same grid, within 1.0 of the float model; the quantized
    model serves."""
    from repro_torch.core import QuantSpec, materialize, quantize_model
    from repro_torch.serve.engine import Engine
    cfg, params, _ = trained
    calib = torch.from_numpy(SyntheticLM(cfg.vocab_size, seed=0)
                             .sample(8, 64, step=5000)["tokens"])
    base = _eval_loss(params, cfg)
    losses, models = {}, {}
    for method in ("comq", "rtn"):
        spec = QuantSpec(bits=3, granularity="per_channel", lam=0.9,
                         sweeps=3, order="greedy")
        qp, _ = quantize_model(params, cfg, BuildPlan(), calib, spec,
                               method=method)
        models[method] = materialize(qp, cfg)
        losses[method] = _eval_loss(models[method], cfg)
    assert losses["comq"] <= losses["rtn"] + 1e-4, (base, losses)
    assert losses["comq"] - base < 1.0, (base, losses)
    eng = Engine(models["comq"], cfg, BuildPlan(), device="cpu")
    out = eng.generate_batch(calib[:2, :32].numpy(), max_new_tokens=8)
    assert out.shape == (2, 8)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()
