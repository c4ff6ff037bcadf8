"""Crash-safe resumable quantization in the port (repro_torch.core.pipeline
with repro_torch.ft), mirroring tests/test_quant_faults.py: a killed and
resumed run must equal an uninterrupted one bit for bit — QT trees, report
rows and packed-checkpoint bytes — on the dense, MoE (mixed policy),
hybrid (SSM state carried across the kill) and VLM (cross leaves
journaled) walks; journal↔spill integrity; torn spill writes; supervised
recovery; the CI fault smoke on the port's launcher. Against the JAX
package: quantize journals read both ways, and the run and spec digests."""
import glob
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_cfg
from repro.core import QuantSpec as JSpec
from repro.core import parse_policy as jax_parse_policy
from repro.core import quantize_model as jax_quantize
from repro.core.pipeline import _run_digest as jax_run_digest
from repro.core.pipeline import _spec_digest as jax_spec_digest
from repro.ft import FaultInjector as JFaultInjector
from repro.ft import QuantJournal as JQuantJournal
from repro.ft import SimulatedKill as JSimulatedKill
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro_torch.ckpt import (CheckpointManager, PackedCkptError,
                              load_packed_ckpt, pack_tree, save_packed_ckpt)
from repro_torch.configs import get_smoke_config
from repro_torch.core import (QuantSpec, as_policy, parse_policy,
                              quantize_model)
from repro_torch.core.pipeline import _run_digest, _spec_digest
from repro_torch.ft import (FaultInjector, InjectedFault, QuantJournal,
                            ResumeMismatch, SimulatedKill)
from repro_torch.launch import quantize as launch_quantize
from repro_torch.models import BuildPlan, init_params

torch.set_num_threads(2)

SPEC = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
                 order="greedy")
PLAN = BuildPlan()


def _setup(arch="qwen2-7b"):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(0))
    kw = {"method": "comq_blocked"}
    if cfg.family == "vlm":
        g = torch.Generator().manual_seed(1)
        kw["vision_embeds"] = torch.randn(
            4, cfg.cross_attn.n_vision_tokens, cfg.cross_attn.vision_dim,
            generator=g)
    return cfg, params, tokens, kw


def _assert_trees_identical(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_trees_identical(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert a.device == b.device and torch.equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _packed_bytes(qparams, path):
    save_packed_ckpt(path, pack_tree(qparams["__qlayers__"]))
    with open(path, "rb") as f:
        return f.read()


def _report_rows(report):
    return [(lr.layer, lr.name, lr.err_before, lr.err_after, lr.guard)
            for lr in report.layers]


def _kill_and_resume(tmp_path, arch, spec, kill):
    """A clean run, a journaled run killed at the `kill`-th layer end, and
    the resumed run; returns (clean, resumed, journaled leaves at the
    kill)."""
    cfg, params, tokens, kw = _setup(arch)
    ref = quantize_model(params, cfg, PLAN, tokens, spec, **kw)
    jd = str(tmp_path / "journal")
    inj = FaultInjector({"kill": [kill]})
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, PLAN, tokens, spec, journal=jd,
                       injector=inj, **kw)
    st = QuantJournal.replay(jd)
    assert st.leaves and not st.done
    assert QuantJournal.check_integrity(jd) == len(st.leaves)
    res = quantize_model(params, cfg, PLAN, tokens, spec, journal=jd,
                         resume=True, injector=inj, **kw)
    assert res[1].resumed_leaves == len(st.leaves)
    assert QuantJournal.replay(jd).done
    _assert_trees_identical(ref[0]["__qlayers__"], res[0]["__qlayers__"])
    assert _report_rows(res[1]) == _report_rows(ref[1])
    return ref, res, st


def test_kill_resume_bit_identical_dense(tmp_path):
    """The oracle: codes, scales, report rows and .qpk bytes of a killed
    and resumed run equal an uninterrupted run's (the unembedding too)."""
    cfg, params, tokens, kw = _setup()
    ref_q, ref_rep = quantize_model(params, cfg, PLAN, tokens, SPEC,
                                    quantize_unembed=True, **kw)
    jd = str(tmp_path / "journal")
    inj = FaultInjector({"kill": [1]})
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                       injector=inj, quantize_unembed=True, **kw)
    st = QuantJournal.replay(jd)
    assert sorted({layer for layer, _ in st.leaves}) == [0]
    qp, rep = quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                             resume=True, injector=inj,
                             quantize_unembed=True, **kw)
    assert rep.resumed_leaves == len(st.leaves) == 7
    _assert_trees_identical(ref_q["__qlayers__"], qp["__qlayers__"])
    _assert_trees_identical(ref_q["unembed"], qp["unembed"])
    assert _report_rows(rep) == _report_rows(ref_rep)
    assert rep.layers[-1].name == "unembed"
    assert _packed_bytes(ref_q, str(tmp_path / "ref.qpk")) == \
        _packed_bytes(qp, str(tmp_path / "res.qpk"))


def test_kill_resume_bit_identical_moe_mixed_policy(tmp_path):
    """The MoE walk (per-expert Grams, the expert-batched solve) under a
    mixed policy, killed after layer 0."""
    ref, res, _ = _kill_and_resume(tmp_path, "granite-moe-3b-a800m",
                                   parse_policy("first=8", SPEC), kill=1)
    assert _packed_bytes(ref[0], str(tmp_path / "a.qpk")) == \
        _packed_bytes(res[0], str(tmp_path / "b.qpk"))
    table = res[0]["__qlayers__"]
    assert table["0"]["moe"]["w_up"]["bits"] == 8
    assert table["1"]["moe"]["w_up"]["bits"] == 4


def test_kill_resume_carries_the_ssm_state(tmp_path):
    """hymba: layer 1 resumes from layer 0's re-applied codes and its final
    SSM state, and solves to the uninterrupted run's codes."""
    ref, res, st = _kill_and_resume(tmp_path, "hymba-1.5b", SPEC, kill=1)
    assert {layer for layer, _ in st.leaves} == {0}
    assert ("ssm.w_in" in {n for _, n in st.leaves})
    assert _packed_bytes(ref[0], str(tmp_path / "a.qpk")) == \
        _packed_bytes(res[0], str(tmp_path / "b.qpk"))


def test_kill_resume_vlm_journals_the_cross_leaves(tmp_path):
    """The VLM walk (two groups of 4 self + 1 cross layer), killed after
    group 0's cross layer (index 4): its cross.* leaves are journaled and
    re-applied, group 1 solves to the uninterrupted run's codes."""
    ref, res, st = _kill_and_resume(tmp_path, "llama-3.2-vision-90b", SPEC,
                                    kill=5)
    cross = sorted(n for layer, n in st.leaves if layer == 4)
    assert cross == ["cross.mlp.w_down", "cross.mlp.w_gate",
                     "cross.mlp.w_up", "cross.xattn.wo", "cross.xattn.wq"]
    assert max(layer for layer, _ in st.leaves) == 4
    assert _packed_bytes(ref[0], str(tmp_path / "a.qpk")) == \
        _packed_bytes(res[0], str(tmp_path / "b.qpk"))


def test_kill_resume_legacy_schedule(tmp_path):
    cfg, params, tokens, kw = _setup()
    ref = quantize_model(params, cfg, PLAN, tokens, SPEC,
                         propagation="legacy", **kw)
    jd = str(tmp_path / "legacy")
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                       propagation="legacy",
                       injector=FaultInjector({"kill": [1]}), **kw)
    res = quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                         resume=True, propagation="legacy", **kw)
    assert res[1].resumed_leaves == 7
    _assert_trees_identical(ref[0]["__qlayers__"], res[0]["__qlayers__"])
    assert _report_rows(res[1]) == _report_rows(ref[1])


def test_resume_skips_the_grams_and_solves_of_journaled_groups(
        tmp_path, monkeypatch):
    """A resumed group is re-applied without its Gram or solve: the
    resumed run takes Grams only for the layers the kill left unsolved."""
    from repro_torch.core import calibrate
    cfg, params, tokens, kw = _setup()
    grams = []
    real = calibrate.gram_from_tap
    monkeypatch.setattr(calibrate, "gram_from_tap",
                        lambda tap: grams.append(1) or real(tap))
    quantize_model(params, cfg, PLAN, tokens, SPEC, **kw)
    per_run = len(grams)
    jd = str(tmp_path / "journal")
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                       injector=FaultInjector({"kill": [1]}), **kw)
    grams.clear()
    quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd, resume=True,
                   **kw)
    assert per_run == 8 and len(grams) == per_run // 2


def test_resume_digest_mismatch_raises(tmp_path):
    cfg, params, tokens, kw = _setup()
    jd = str(tmp_path / "journal")
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                       injector=FaultInjector({"kill": [1]}), **kw)
    other = QuantSpec(bits=3, granularity="per_channel", lam=0.9, sweeps=1,
                      order="greedy")
    with pytest.raises(ResumeMismatch):
        quantize_model(params, cfg, PLAN, tokens, other, journal=jd,
                       resume=True, **kw)
    with pytest.raises(ResumeMismatch):
        quantize_model(params, cfg, PLAN, tokens, SPEC, method="rtn",
                       journal=jd, resume=True)
    with pytest.raises(ResumeMismatch):
        quantize_model(params, cfg, PLAN, tokens.flip(0), SPEC, journal=jd,
                       resume=True, **kw)


def test_ckpt_write_fault_never_journals_torn_leaf(tmp_path):
    cfg, params, tokens, kw = _setup()
    ref_q, _ = quantize_model(params, cfg, PLAN, tokens, SPEC, **kw)
    jd = str(tmp_path / "journal")
    inj = FaultInjector({"ckpt_write": [1]})
    with pytest.raises(InjectedFault):
        quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                       injector=inj, **kw)
    st = QuantJournal.replay(jd)
    torn = glob.glob(os.path.join(jd, "leaves", "*.tmp"))
    assert torn, "the injected torn write should leave a .tmp behind"
    for t in torn:
        assert not os.path.exists(t[:-len(".tmp")])
        assert os.path.basename(t)[:-len(".tmp")] not in {
            rec["file"] for rec in st.leaves.values()}
    QuantJournal.check_integrity(jd)
    qp, _ = quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                           resume=True, injector=inj, **kw)
    _assert_trees_identical(ref_q["__qlayers__"], qp["__qlayers__"])


def test_nan_tap_fault_is_guarded_and_journaled(tmp_path):
    """nan_tap raises nothing: the guard records nonfinite_tap, the run
    stays finite, and the guarded leaves are journaled like any other."""
    cfg, params, tokens, kw = _setup()
    jd = str(tmp_path / "journal")
    with pytest.warns(UserWarning, match="nonfinite_tap"):
        qp, rep = quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                                 injector=FaultInjector({"nan_tap": [1]}),
                                 **kw)
    kinds = {(e.layer, e.name, e.kind) for e in rep.guard_events}
    assert (0, "attn.wq", "nonfinite_tap") in kinds
    assert all(np.isfinite(lr.err_after) for lr in rep.layers)
    assert QuantJournal.check_integrity(jd) == len(rep.layers)


def test_integrity_check_detects_corrupt_spill(tmp_path):
    cfg, params, tokens, kw = _setup()
    jd = str(tmp_path / "journal")
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                       injector=FaultInjector({"kill": [1]}), **kw)
    rec = next(iter(QuantJournal.replay(jd).leaves.values()))
    path = os.path.join(jd, "leaves", rec["file"])
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(PackedCkptError):
        QuantJournal.check_integrity(jd)
    os.remove(path)
    with pytest.raises(PackedCkptError):
        QuantJournal.check_integrity(jd)


def test_supervised_restarts_recover_multiple_faults(tmp_path):
    """The launcher's supervisor (`quantize_supervised`) converges through
    a kill, a Gram fault and a leaf-solve fault to the clean run's bytes,
    with a heartbeat in the journal directory."""
    cfg, params, tokens, kw = _setup()
    ref_q, _ = quantize_model(params, cfg, PLAN, tokens, SPEC, **kw)
    jd = str(tmp_path / "journal")
    inj = FaultInjector({"kill": [1], "gram_accumulate": [6],
                         "leaf_solve": [9]})
    layers = []
    qp, rep = launch_quantize.quantize_supervised(
        params, cfg, PLAN, tokens, SPEC, journal=jd, restarts=3,
        injector=inj, progress_cb=layers.append, **kw)
    assert len(inj.fired) == 3
    assert QuantJournal.replay(jd).done and rep.resumed_leaves > 0
    assert layers[0] == 0 and layers[-1] == 1
    assert os.path.exists(os.path.join(jd, "heartbeat_0"))
    _assert_trees_identical(ref_q["__qlayers__"], qp["__qlayers__"])
    assert _packed_bytes(ref_q, str(tmp_path / "ref.qpk")) == \
        _packed_bytes(qp, str(tmp_path / "sup.qpk"))
    with pytest.raises(InjectedFault):      # no restarts: it propagates
        launch_quantize.quantize_supervised(
            params, cfg, PLAN, tokens, SPEC, journal=str(tmp_path / "j2"),
            injector=FaultInjector({"leaf_solve": [1]}), **kw)


def test_journaling_alone_changes_nothing(tmp_path):
    cfg, params, tokens, kw = _setup()
    ref_q, ref_rep = quantize_model(params, cfg, PLAN, tokens, SPEC, **kw)
    jd = str(tmp_path / "journal")
    q1, rep1 = quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                              **kw)
    assert rep1.resumed_leaves == 0
    _assert_trees_identical(ref_q["__qlayers__"], q1["__qlayers__"])
    assert _report_rows(rep1) == _report_rows(ref_rep)
    q2, rep2 = quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                              resume=True, **kw)
    assert rep2.resumed_leaves == len(rep2.layers)
    _assert_trees_identical(ref_q["__qlayers__"], q2["__qlayers__"])


def test_injector_rejects_unknown_pipeline_point():
    with pytest.raises(ValueError):
        FaultInjector.parse("gram_acumulate:1")


CI_ARGS = ["--arch", "qwen2-7b", "--smoke", "--bits", "4", "--method",
           "comq_blocked", "--sweeps", "2", "--calib-batch", "2",
           "--calib-seq", "48", "--device", "cpu"]


def test_ci_fault_smoke_on_the_port_launcher(tmp_path):
    """ci.yml's "Quantize fault smoke" with the port's launcher: a clean
    run and a kill:2 run under --restarts 3 write byte-identical .qpk
    files, and each CheckpointManager step_0 restores to the .qpk's
    arrays."""
    ref = launch_quantize.main(CI_ARGS + [
        "--out-dir", str(tmp_path / "q_ref"),
        "--save-packed", str(tmp_path / "ref.qpk")])
    fault = launch_quantize.main(CI_ARGS + [
        "--out-dir", str(tmp_path / "q_fault"),
        "--journal", str(tmp_path / "qjournal"), "--inject", "kill:2",
        "--restarts", "3", "--save-packed", str(tmp_path / "fault.qpk")])
    with open(tmp_path / "ref.qpk", "rb") as a, \
            open(tmp_path / "fault.qpk", "rb") as b:
        assert a.read() == b.read()
    assert ref["resumed_leaves"] == 0 and ref["faults_fired"] == 0
    assert fault["resumed_leaves"] == 14 and fault["faults_fired"] == 1
    tree = load_packed_ckpt(str(tmp_path / "ref.qpk"))["tree"]
    for d in ("q_ref", "q_fault"):
        out, meta = CheckpointManager(str(tmp_path / d)).restore(0, tree)
        assert meta["extra"]["arch"] == "qwen2-7b-smoke"
        assert meta["extra"]["policy"]["base"]["bits"] == 4
        for layer, lp in tree.items():
            for mod, leaves in lp.items():
                for leaf, v in leaves.items():
                    got = out[layer][mod][leaf]
                    if isinstance(v, dict):
                        for k in ("codes", "scale", "z_lo"):
                            assert np.array_equal(got[k], v[k])
                    else:
                        assert np.array_equal(got, v)
    with pytest.raises(SystemExit, match="needs --journal"):
        launch_quantize.main(CI_ARGS + ["--restarts", "1"])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _leaf_table(st):
    return {k: (r["file"], r["crc32"], r["spec"]) for k, r in
            st.leaves.items()}


def test_port_journal_passes_jax_replay_and_integrity(tmp_path):
    """A journal directory written by the port (killed mid-run) passes
    JAX's replay and check_integrity with the port's leaf keys and crcs,
    and JAX's load_leaf returns the port's spilled arrays."""
    cfg, params, tokens, kw = _setup()
    jd = str(tmp_path / "journal")
    with pytest.raises(SimulatedKill):
        quantize_model(params, cfg, PLAN, tokens, SPEC, journal=jd,
                       injector=FaultInjector({"kill": [1]}), **kw)
    ours, theirs = QuantJournal.replay(jd), JQuantJournal.replay(jd)
    assert _leaf_table(ours) == _leaf_table(theirs) and len(ours.leaves) == 7
    assert ours.run == theirs.run and not theirs.done
    assert JQuantJournal.check_integrity(jd) == \
        QuantJournal.check_integrity(jd) == 7
    for rec in ours.leaves.values():
        a = QuantJournal.load_leaf(jd, rec)
        b = JQuantJournal.load_leaf(jd, rec)
        assert sorted(a) == sorted(b)
        for k in ("codes", "scale", "z_lo"):
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype


def test_jax_journal_passes_port_replay_and_integrity(tmp_path):
    """The reverse: a JAX-written quantize journal passes the port's
    replay, check_integrity and load_leaf, and its run digest is the one
    the port computes for the same run."""
    jcfg = jax_cfg("qwen2-7b")
    jplan = JPlan(remat=False)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg, jplan)
    tok = np.random.RandomState(0).randint(0, jcfg.vocab_size,
                                           (4, 64)).astype(np.int32)
    jspec = JSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=1,
                  order="greedy")
    jd = str(tmp_path / "journal")
    with pytest.raises(JSimulatedKill):
        jax_quantize(jparams, jcfg, jplan, tok, jspec,
                     method="comq_blocked", journal=jd,
                     injector=JFaultInjector({"kill": [1]}))
    ours, theirs = QuantJournal.replay(jd), JQuantJournal.replay(jd)
    assert _leaf_table(ours) == _leaf_table(theirs) and len(ours.leaves) == 7
    assert QuantJournal.check_integrity(jd) == 7
    for rec in ours.leaves.values():
        qt = QuantJournal.load_leaf(jd, rec)
        assert qt["codes"].dtype == np.uint8 and qt["bits"] == 4
    cfg = get_smoke_config("qwen2-7b")
    assert ours.run["run"] == _run_digest(
        cfg, as_policy(SPEC), "comq_blocked", "staged",
        torch.from_numpy(tok).long(), False)
    for (layer, name), rec in ours.leaves.items():
        assert rec["spec"] == _spec_digest(SPEC, "comq_blocked")


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "rwkv6-7b",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("policy", ["", "first=8,*.w_down=8,kv=4"])
def test_digests_equal_jax(arch, policy):
    """_spec_digest and _run_digest equal JAX's on the same spec, policy
    and tokens (the port's int64 ids hashed as int32, the JAX launcher's
    type), for each method, schedule and unembed flag."""
    from repro.core import as_policy as jax_as_policy
    base = dict(bits=3, granularity="per_channel", lam=0.9, sweeps=2,
                order="cyclic")
    spec, jspec = QuantSpec(**base), JSpec(**base)
    pol = parse_policy(policy, spec) if policy else as_policy(spec)
    jpol = (jax_parse_policy(policy, jspec) if policy
            else jax_as_policy(jspec))
    tok = np.random.RandomState(3).randint(0, 256, (2, 48)).astype(np.int32)
    cfg, jcfg = get_smoke_config(arch), jax_cfg(arch)
    for method in ("comq", "comq_blocked", "rtn", "gptq"):
        assert _spec_digest(spec, method) == jax_spec_digest(jspec, method)
        for bits in (2, 8):
            assert _spec_digest(QuantSpec(**{**base, "bits": bits}),
                                method) == \
                jax_spec_digest(JSpec(**{**base, "bits": bits}), method)
        for prop in ("staged", "legacy"):
            for unembed in (False, True):
                assert _run_digest(cfg, pol, method, prop,
                                   torch.from_numpy(tok).long(), unembed) \
                    == jax_run_digest(jcfg, jpol, method, prop, tok,
                                      unembed, None)
