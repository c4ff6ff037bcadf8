"""The training step as one compiled program: the fused AdamW leaf update
(`kernels.ops.adamw_update_leaf`, csrc/adamw.cu on the card) and the
Trainer's step under `analysis.retrace.guard_graph` ("train.step"), on
the CPU.

On the CPU the leaf update dispatches to its plain version, which must be
the update the optimizer ran before the kernel existed: it is held bit
for bit to that code, kept here (`_pre_update`, with the step's clip
multiply `g.mul_(factor)` before it), in f32 and int8 moments, at a
ragged last block, a 1-d leaf and a 0-d leaf, and to JAX's `adamw_update`.
The guarded Trainer runs its step eagerly through the guard's static
buffers and refuses at the first call what a capture refuses: it is held
bit for bit to `make_train_step` called directly (losses, params,
moments), with one signature over 6 steps and the counter advanced in
place, and through a kill and resume. The card's side (kernel against
plain, replay against eager) is in test_torch_cuda.py; the families'
Trainer parity with JAX, through the same guard, in
test_torch_trainer.py and test_torch_trainer_families.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro_torch.analysis.retrace import GraphCaptureError, compile_count
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.data import SyntheticLM
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import ops
from repro_torch.models import BuildPlan
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import adamw as tadamw
from repro_torch.roofline import kernels as cost
from repro_torch.roofline.analysis import count_cost
from repro_torch.train import Trainer, make_train_step
from repro_torch.train.trainer import STEP_NAME

torch.set_num_threads(2)

# a ragged last block (300 = 256 + 44), whole blocks, 1-d ragged, 0-d
LEAF_SHAPES = [(5, 300), (3, 256), (600,), ()]
MOMENTS = ["float32", "int8"]


def _leaves(tree):
    return pytree.tree_leaves(tree)


# ---------------------------------------------------------------------------
# the leaf update against the optimizer's code before the kernel
# ---------------------------------------------------------------------------

def _read(enc, cfg, shape, signed):
    if cfg.moment_dtype != "int8":
        return enc
    return (kadamw.decode_m if signed else kadamw.decode_v)(enc, shape)


def _write(val, cfg, signed):
    if cfg.moment_dtype != "int8":
        return val
    return (kadamw.encode_m if signed else kadamw.encode_v)(val)


def _pre_update(p, g, m_enc, v_enc, step, cfg, lr, factor):
    """The optimizer's update of one leaf as it was before the fused
    kernel (the train step's `g.mul_(factor)`, then `upd`): returns new
    (p, m, v), the inputs untouched."""
    g = g.clone()
    g.mul_(factor)
    t = (step + 1).to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), t)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), t)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    g = g.float()
    m = _read(m_enc, cfg, p.shape, True)
    v = _read(v_enc, cfg, p.shape, False)
    m = cfg.b1 * m + (1.0 - cfg.b1) * g
    v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
    mh = m / c1
    vh = v / c2
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
    return ((p - lr * delta).to(p.dtype),
            _write(m, cfg, True),
            _write(v, cfg, False))


@pytest.mark.parametrize("shape", LEAF_SHAPES, ids=str)
@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_leaf_update_equals_the_pre_kernel_update(moment_dtype, shape):
    """Four steps of `ops.adamw_update_leaf` (in place, the clip factor
    folded in) equal the pre-kernel update bit for bit: params, moments,
    codes, scales and EF planes."""
    rs = np.random.RandomState(len(shape) + 11)
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    p0 = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    state = adamw_init({"w": p0}, cfg)
    got = [p0.clone(), state["m"]["w"], state["v"]["w"]]
    want = [p0.clone(), *pytree.tree_map(torch.clone, (got[1], got[2]))]
    lr = torch.tensor(3e-3)
    for i in range(4):
        g = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
        factor = torch.tensor(0.25 + 0.2 * i, dtype=torch.float32)
        step = torch.tensor(i, dtype=torch.int32)
        want = list(_pre_update(*want[:1], g, *want[1:], step, cfg, lr,
                                factor))
        lr_, c1, c2 = tadamw.bias_corrections(step + 1, cfg, lr)
        ops.adamw_update_leaf(got[0], g, got[1], got[2], lr=lr_, c1=c1,
                              c2=c2, cfg=cfg, factor=factor)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_leaf_update_tracks_jax(moment_dtype):
    """`adamw_update_` (the leaf update per leaf) against JAX's
    `adamw_update` over three steps at the ragged, 1-d and 0-d leaves:
    params within f32 rounding; int8 codes at most one level apart (the
    two libraries' pow differ in the last bit of the bias corrections)."""
    rs = np.random.RandomState(5)
    shapes = {"a": (5, 300), "b": (600,), "c": ()}
    tree = {k: rs.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    jcfg = JAdamWConfig(moment_dtype=moment_dtype)
    tp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    ts = adamw_init(tp, cfg)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    js = jadamw.adamw_init(jp, jcfg)
    for _ in range(3):
        g = {k: rs.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        tp, ts = tadamw.adamw_update_(
            {k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, cfg,
            torch.tensor(1e-2))
        jp, js = jadamw.adamw_update({k: jnp.asarray(v) for k, v in
                                      g.items()}, js, jp, jcfg,
                                     jnp.float32(1e-2))
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    if moment_dtype == "int8":
        for k in shapes:
            for mom in ("m", "v"):
                a = ts[mom][k]["q"].numpy().astype(int)
                b = np.asarray(js[mom][k]["q"]).astype(int)
                assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_leaf_update_charges_its_kernel_cost(moment_dtype):
    """Under a count the leaf update costs its kernel's cost function,
    whatever runs it (28 bytes a parameter with f32 moments, ~16.6 with
    the codec, its padded codes counted)."""
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    p = torch.ones(5, 300)
    st = adamw_init({"w": p}, cfg)
    scalars = tadamw.bias_corrections(torch.tensor(1), cfg, 1e-3)
    got = count_cost(ops.adamw_update_leaf, p, torch.ones(5, 300),
                     st["m"]["w"], st["v"]["w"], lr=scalars[0],
                     c1=scalars[1], c2=scalars[2], cfg=cfg,
                     factor=torch.tensor(0.5))
    want = cost.adamw_update(1500, moment_dtype,
                             5 * 512 if moment_dtype == "int8" else None)
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes)
    n = 256 * 4096          # whole blocks: no padded codes
    per = (cost.adamw_update(n, moment_dtype).bytes - 16) / n
    assert per == (28.0 if moment_dtype == "float32" else 16.5625)


def test_leaf_update_on_a_cuda_tensor_needs_the_card():
    """No fallback: a non-CPU tensor goes to the kernel wrapper, which
    raises without a card rather than running the plain version."""
    with pytest.raises(RuntimeError, match="CUDA"):
        kadamw.adamw_leaf_cuda(torch.ones(3), torch.ones(3), torch.ones(3),
                               torch.ones(3), lr=torch.tensor(1.0),
                               c1=torch.tensor(1.0), c2=torch.tensor(1.0),
                               cfg=AdamWConfig())


# ---------------------------------------------------------------------------
# the Trainer's guarded step against make_train_step called directly
# ---------------------------------------------------------------------------

B, T, STEPS = 4, 32, 6


def _run_cfg(tmp_path, **kw):
    base = dict(arch="qwen2-7b", ckpt_dir=str(tmp_path), ckpt_every=100,
                total_steps=10, learning_rate=3e-3, warmup_steps=2,
                async_ckpt=False)
    base.update(kw)
    return RunConfig(**base)


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_guarded_step_equals_the_direct_step(tmp_path, moment_dtype):
    """6 Trainer steps (the step under guard_graph) against 6 direct
    calls of make_train_step on the same batches: losses, grad norms,
    params and moments bit for bit; one signature; the counter advanced
    in place and the same state object returned every step."""
    cfg = get_smoke_config("qwen2-7b")
    acfg = AdamWConfig(moment_dtype=moment_dtype)
    run_cfg = _run_cfg(tmp_path)
    t = Trainer(cfg, BuildPlan(remat=False), run_cfg, adamw_cfg=acfg,
                device="cpu")
    program = t._step_program()
    state, _ = t.resume_or_init()
    counter = state["opt"]["step"]
    gen = SyntheticLM(cfg.vocab_size, seed=run_cfg.seed)
    batches = [{k: torch.from_numpy(v) for k, v in
                gen.sample(B, T, i).items()} for i in range(STEPS)]
    got = []
    for b in batches:
        out, m = program(state, b["tokens"], b["labels"])
        assert out is state
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    int(m["step"])))
    assert compile_count(STEP_NAME) == 1
    assert state["opt"]["step"] is counter and int(counter) == STEPS

    step = make_train_step(cfg, BuildPlan(remat=False), run_cfg, acfg)
    ref, _ = t.resume_or_init()
    want = []
    for b in batches:
        ref, m = step(ref, b)
        want.append((float(m["loss"]), float(m["grad_norm"]),
                     int(m["step"])))
    assert got == want
    assert [s for _, _, s in got] == list(range(1, STEPS + 1))
    for a, b in zip(_leaves(state), _leaves(ref)):
        assert torch.equal(a, b)


def test_a_host_read_in_the_trainer_step_raises_and_runs_nothing(tmp_path):
    """A step that reads a value back to the host is refused at its first
    call, as the card's capture refuses it, and no eager step runs in its
    place: the state is untouched."""
    cfg = get_smoke_config("qwen2-7b")
    t = Trainer(cfg, BuildPlan(remat=False), _run_cfg(tmp_path),
                device="cpu")
    real = t.step_fn

    def reads_back(state, batch):
        if float(batch["tokens"].sum()) < 0:      # a host read
            return state, {}
        return real(state, batch)
    t.step_fn = reads_back
    state, _ = t.resume_or_init()
    before = [x.clone() for x in _leaves(state)]
    tok = torch.zeros(B, T, dtype=torch.int32)
    with pytest.raises(GraphCaptureError, match="_local_scalar_dense"):
        t._step_program()(state, tok, tok)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(state), before))


def test_int8_ef_runs_its_step_eagerly(tmp_path):
    """With grad_compression="int8_ef" (a gloo all-reduce through host
    memory) the configuration runs the step eagerly: no graph guard."""
    t = Trainer(get_smoke_config("qwen2-7b"), BuildPlan(remat=False),
                _run_cfg(tmp_path, grad_compression="int8_ef"),
                device="cpu")
    assert not hasattr(t._step_program(), "__comq_graphs__")
    t2 = Trainer(get_smoke_config("qwen2-7b"), BuildPlan(remat=False),
                 _run_cfg(tmp_path), device="cpu")
    assert hasattr(t2._step_program(), "__comq_graphs__")


def test_kill_and_resume_through_the_guarded_step(tmp_path):
    """int8 moments, a checkpoint every 3 steps, a kill after step 4: the
    restarted Trainer loads into its state's own tensors, captures anew
    and its losses from step 4 on equal an unbroken run's bit for bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ft import run_with_restarts
    cfg = get_smoke_config("qwen2-7b")
    acfg = AdamWConfig(moment_dtype="int8")
    kw = dict(ckpt_every=3, total_steps=STEPS)
    killed = {"done": False}
    history = []

    def bomb(step):
        if step == 4 and not killed["done"]:
            killed["done"] = True
            raise RuntimeError("injected node failure")

    def attempt(resume_step):
        t = Trainer(cfg, BuildPlan(remat=False),
                    _run_cfg(tmp_path / "k", **kw), adamw_cfg=acfg,
                    failure_hook=bomb, device="cpu")
        try:
            return t.run_loop(STEPS, T, B)["final_step"]
        finally:
            history.append((resume_step,
                            [m["loss"] for m in t.metrics_log]))
            assert compile_count(STEP_NAME) == 1

    final = run_with_restarts(
        attempt, lambda: CheckpointManager(str(tmp_path / "k")).latest_step(),
        max_restarts=2)
    ref = Trainer(cfg, BuildPlan(remat=False),
                  _run_cfg(tmp_path / "r", **kw), adamw_cfg=acfg,
                  device="cpu").run_loop(STEPS, T, B)
    want = [m["loss"] for m in ref["metrics"]]
    assert final == STEPS and killed["done"]
    (first_from, first), (resumed_from, resumed) = history
    assert (first_from, resumed_from) == (None, 3)
    assert first == want[:4] and resumed == want[3:]
