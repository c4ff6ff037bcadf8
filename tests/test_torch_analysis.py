"""The port's contract gate (repro_torch.analysis), the counterpart of
tests/test_analysis.py minus the donation audit (no torch program has an
alias table): the collective census catches a planted all-reduce, a
contract catches it and an out-of-place pool update, the signature guard
trips on a shape-varying loop, the runtime's decode step sees one
signature across a mixed, staggered run, the lint flags torch syncs and
honours its pragmas (and its durability rule agrees with JAX's), and the
whole gate, its gloo world of 2 included, passes on the CPU."""
import inspect
import json
import os
import subprocess
import sys
import tokenize
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.analysis.lint import lint_source as jax_lint_source
from repro_torch.analysis import Census, collective_census
from repro_torch.analysis.contracts import (Contract, ContractViolation,
                                            assert_contract, check_call,
                                            contract, contract_of)
from repro_torch.analysis.lint import (HOT_ZONES, RULES, lint_paths,
                                       lint_source, qualnames)
from repro_torch.analysis.retrace import (GuardRecord, RetraceViolation,
                                          compile_count, guard_fn,
                                          reset_guards)
from repro_torch.roofline.analysis import count_cost

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def world():
    """A gloo world of one in this process, ended after the module."""
    from repro_torch.dist import world as w
    _, started = w.init_world("gloo", "cpu")
    yield
    w.close_world(started)


def _planted(x):
    y = x @ x
    dist.all_reduce(y)
    return y


# ---------------------------------------------------------------------------
# collective census
# ---------------------------------------------------------------------------

def test_census_counts_planted_all_reduce(world):
    x = torch.ones(4, 4)
    assert collective_census(_planted, x) == {"all_reduce": 1}

    def several():
        _planted(x)
        dist.all_reduce(x)
        dist.all_gather([torch.empty_like(x)], x)
        dist.barrier()

    assert collective_census(several) == {"all_reduce": 2, "all_gather": 1,
                                          "barrier": 1}


def test_census_clean_call_is_empty_and_scopes_count_apart(world):
    x = torch.ones(8, 8)
    assert collective_census(lambda: x @ x) == {}
    with Census() as c:
        dist.all_reduce(x)
        with torch.profiler.record_function("decode_step"):
            _planted(x)
    assert c.counts == {"all_reduce": 2}
    assert c.within("decode_step") == {"all_reduce": 1}
    assert c.within("elsewhere") == {}


def test_count_cost_counts_collective_bytes_by_primitive(world):
    x = torch.ones(4, 4)
    c = count_cost(_planted, x)
    assert c.collective_bytes == {"all_reduce": 64.0}
    assert c.flops == 2 * 4 * 4 * 4
    parts = [torch.empty(4, 4)]
    c = count_cost(dist.all_gather, parts, x)
    assert c.collective_bytes == {"all_gather": 64.0}


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def test_contract_catches_planted_all_reduce(world):
    """collectives=0 rejects the planted all-reduce; the exact
    per-primitive count accepts it and rejects a wrong primitive."""
    x = torch.ones(4, 4)
    viol = check_call(Contract(name="planted", collectives=0), _planted, x)
    assert viol and "all_reduce" in viol[0] and "[planted]" in viol[0]
    assert check_call(Contract(collectives={"all_reduce": 1}), _planted,
                      x) == []
    viol = check_call(Contract(collectives={"all_gather": 1}), _planted, x)
    assert len(viol) == 2       # missing all_gather AND extra all_reduce
    with pytest.raises(ContractViolation):
        assert_contract(Contract(name="planted", collectives=0), _planted,
                        x)


def _pool():
    return {"k": torch.zeros(2, 4, 3), "v": torch.zeros(2, 4, 3),
            "step": torch.zeros((), dtype=torch.int32)}


def test_inplace_accepts_an_update_in_place():
    def write(pool, rows):
        pool["k"][:, 1] = rows
        pool["v"][:, 1].add_(rows)
        pool["step"] = pool["step"] + 1     # a scalar may be replaced
        return pool

    con = Contract(name="write", inplace=(0,))
    assert check_call(con, write, _pool(), torch.ones(2, 3)) == []


def test_inplace_catches_an_out_of_place_pool_update():
    def out_of_place(pool, rows):
        k = pool["k"].clone()
        k[:, 1] = rows
        return {**pool, "k": k}

    def rebinds(pool, rows):
        pool["v"] = torch.cat([pool["v"][:, :1], rows[:, None],
                               pool["v"][:, 2:]], dim=1)
        return rows.sum()

    con = Contract(name="pool", inplace=(0,))
    viol = check_call(con, out_of_place, _pool(), torch.ones(2, 3))
    assert len(viol) == 1 and "out of place" in viol[0]
    viol = check_call(con, rebinds, _pool(), torch.ones(2, 3))
    assert len(viol) == 1 and "1/2 leaves replaced" in viol[0]


def test_contract_decorator_attaches_metadata():
    @contract(collectives={"all_reduce": 1}, inplace=(1,), notes="n")
    def fn(a, b):
        return b

    con = contract_of(fn)
    assert con.collectives == {"all_reduce": 1} and con.inplace == (1,)
    assert con.name == "fn" and contract_of(lambda: 0) is None


# ---------------------------------------------------------------------------
# signature guard
# ---------------------------------------------------------------------------

def test_retrace_guard_trips_on_shape_varying_loop():
    """A budget-1 entry point fed growing shapes: strict mode (active
    under pytest) raises on the second signature."""
    reset_guards("t.shape_loop")
    g = guard_fn(lambda x: x * 2.0, name="t.shape_loop", max_signatures=1)
    g(torch.ones(4))
    assert compile_count("t.shape_loop") == 1
    with pytest.raises(RetraceViolation):
        g(torch.ones(5))


def test_retrace_guard_cache_hits_are_free():
    reset_guards("t.stable")
    g = guard_fn(lambda x, n: x + n, name="t.stable", max_signatures=1)
    for _ in range(5):
        g(torch.ones(8), n=1)
    assert compile_count("t.stable") == 1
    with pytest.raises(RetraceViolation):      # a static operand counts
        g(torch.ones(8), n=2)


def test_retrace_per_signature_allows_distinct_shapes_and_dtypes():
    reset_guards("t.sweep")
    g = guard_fn(lambda x: x.sum(), name="t.sweep", per_signature=True)
    for n in (4, 8, 16):
        g(torch.ones(n))
        g(torch.ones(n))
    g(torch.ones(4, dtype=torch.float64))
    assert compile_count("t.sweep") == 4


def test_retrace_per_signature_flags_repeat_trace():
    """The wrapper notes new signatures only, so the repeat branch is
    exercised on the record directly (JAX's cache-thrash check)."""
    rec = GuardRecord("t.thrash", per_signature=True)
    assert rec.note_trace(("sig",)) is None
    msg = rec.note_trace(("sig",))
    assert msg and "thrash" in msg


def test_runtime_declares_its_guards():
    from repro_torch.serve import runtime
    src = inspect.getsource(runtime.Runtime)
    assert 'name="serve.decode_step"' in src
    assert 'name=f"serve.prefill[{bucket}]"' in src
    assert 'name=f"serve.prefill_write[{cache_len}]"' in src
    assert src.count("max_signatures=1") == 3
    assert src.count("guard_graph(") == 3 and "guard_fn" not in src


def test_runtime_decode_guard_one_signature_mixed_staggered():
    """The CLI's --retrace section: one decode-step signature across a
    mixed-length, staggered run with a sampling latecomer."""
    from repro_torch.analysis.cli import run_retrace_smoke
    out = {}
    assert run_retrace_smoke(quiet=True, device="cpu", out=out) == 0
    assert compile_count("serve.decode_step") == 1
    assert out["retrace"]["signatures"] == {
        "serve.decode_step": 1, "serve.prefill[8]": 1,
        "serve.prefill[16]": 1, "serve.prefill_write[8]": 1,
        "serve.prefill_write[16]": 1}


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

_HOT_SYNC_SRC = '''
class Runtime:
    def step(self):
        toks = self._decode(x).cpu().numpy()
        n = float(self.count.sum())
        torch.cuda.synchronize()
        first = logits.argmax().item()
        return toks, n, first, rows.tolist(), len(rows)
'''

_HOT_SYNC_PRAGMA_SRC = '''
class Runtime:
    def step(self):
        # comq: allow(host-sync) streaming tokens is a sync by design
        toks = self._decode(x).cpu().numpy()
        return toks
'''


def test_lint_flags_torch_host_syncs_in_hot_zone():
    finds = lint_source(_HOT_SYNC_SRC, "serve/runtime.py")
    assert [f.rule for f in finds] == ["host-sync"] * 6
    assert {f.line for f in finds} == {4, 5, 6, 7, 8}
    # the same code outside a hot zone: silent
    assert lint_source(_HOT_SYNC_SRC, "serve/other.py") == []


def test_lint_pragma_waives_host_sync():
    assert lint_source(_HOT_SYNC_PRAGMA_SRC, "serve/runtime.py") == []
    # a pragma naming another rule waives nothing
    src = _HOT_SYNC_PRAGMA_SRC.replace("host-sync", "time-in-capture")
    assert [f.rule for f in lint_source(src, "serve/runtime.py")] == \
        ["host-sync", "host-sync"]


_TIME_IN_CAPTURE_SRC = '''
import time, torch

def step(x):
    t0 = time.time()
    return x * t0

step_c = torch.compile(step)
lam = torch.compile(lambda x: x + time.perf_counter())

@torch.compile(mode="reduce-overhead")
def fused(x):
    return x + time.monotonic()

graphed = torch.cuda.make_graphed_callables(step, (x,))
with torch.cuda.graph(g):
    y = model(x) * time.time()
'''


def test_lint_flags_time_in_capture():
    finds = lint_source(_TIME_IN_CAPTURE_SRC, "core/whatever.py")
    assert {f.rule for f in finds} == {"time-in-capture"}
    # step's body (once, though compiled and graphed), the lambda, fused's
    # body, the graph block
    assert sorted(f.line for f in finds) == [5, 9, 13, 17]


def test_lint_time_ok_outside_capture():
    src = "import time\n\ndef wall():\n    return time.time()\n"
    assert lint_source(src, "core/whatever.py") == []


_REPLACE_SRC = '''
import os

def publish(tmp, dst):
    os.replace(tmp, dst)

def publish_durable(tmp, dst, fh):
    os.fsync(fh.fileno())
    os.replace(tmp, dst)
'''


@pytest.mark.parametrize("relpath", ["ft/journal.py", "ckpt/checkpoint.py",
                                     "serve/engine.py"])
def test_lint_fsync_before_replace_equals_jax(relpath):
    got = [(f.path, f.line, f.rule, f.message)
           for f in lint_source(_REPLACE_SRC, relpath)]
    want = [(f.path, f.line, f.rule, f.message)
            for f in jax_lint_source(_REPLACE_SRC, relpath)]
    assert got == want
    assert len(got) == (0 if relpath.startswith("serve") else 1)


def test_lint_port_tree_is_clean_and_zones_map():
    """The port's source passes its own gate (pragmas included), every
    hot zone names a function the port has, and every pragma names one
    of the rules."""
    finds = lint_paths([str(PKG)], root=str(ROOT))
    assert finds == [], [str(f) for f in finds]
    import ast
    for rel, zones in HOT_ZONES.items():
        have = qualnames(ast.parse((PKG / rel).read_text()))
        assert set(zones) <= have, (rel, set(zones) - have)
    n = 0
    for path in PKG.rglob("*.py"):
        with open(path, encoding="utf-8") as fh:
            for tok in tokenize.generate_tokens(fh.readline):
                if tok.type == tokenize.COMMENT and "comq: allow(" in \
                        tok.string:
                    rules = tok.string.split("allow(")[1].split(")")[0]
                    assert {r.strip() for r in rules.split(",")} <= \
                        set(RULES), (path, tok.string)
                    n += 1
    assert n >= 8


# ---------------------------------------------------------------------------
# registry + CLI gate
# ---------------------------------------------------------------------------

def test_registry_solver_entry_passes():
    from repro_torch.analysis.registry import ENTRIES, Smoke
    assert ENTRIES["solver.comq_blocked"].run(Smoke("cpu")) == []


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """`python -m repro_torch.analysis.cli --gate --device cpu`, once: its
    exit status and its --json results (the dist.* entries ran in its
    gloo world of 2)."""
    out = tmp_path_factory.mktemp("gate") / "gate.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.cli", "--gate",
         "--device", "cpu", "--json", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    return proc, json.loads(out.read_text()) if out.exists() else {}


def test_registry_dist_entries_pass_in_a_gloo_world_of_2(gate):
    _, res = gate
    for name in ("dist.gram", "dist.solve", "serve.decode_step_q8_tp"):
        row = res["contracts"][name]
        assert row["skipped"] == "" and row["violations"] == [], (name, row)


def test_cli_gate_exits_clean_on_the_cpu(gate):
    proc, res = gate
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert res["failures"] == 0 and res["lint"] == []
    assert len(res["contracts"]) == 9
    assert "analysis gate: CLEAN" in proc.stdout
