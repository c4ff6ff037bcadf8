"""The registry of gated entry points (port of `repro.analysis.registry`).

Each entry runs one call the port's performance story depends on, on a
smoke-sized qwen2-7b (4-bit RTN codes in the packed serving form, f32
compute and pages) on the device asked for, and checks its `Contract`
with `analysis.contracts.check_call`:

* ``serve.decode_step``    — zero collectives; the paged KV pool updated
  in place;
* ``serve.decode_step_q8`` — the same on int8 pages (per-page scales
  dequantized inside the attention kernel);
* ``serve.decode_step_q8_tp`` — the slot+page-sharded decode step of a
  rank on a model axis of 2: still no collective inside the step, its
  pool updated in place;
* ``serve.prefill``        — zero collectives (one bucket's forward,
  through its graph);
* ``serve.prefill_write``  — the pool updated in place by the scatter
  (through its graph);
* ``solver.comq_blocked``  — zero collectives;
* ``train.step``           — the train state (params, moments) updated in
  place;
* ``dist.solve``           — a rank's column solve issues no collective;
* ``dist.gram``            — exactly one all-reduce a tap Gram.

On the card each entry must also launch its kernels (`Entry.kernels`,
read from `kernels.ops.launch_counts`). The ``min_devices=2`` entries run
in a gloo world of 2 ranks (`torch.distributed.run --standalone`, which
picks a free port) in subprocesses, both ranks on one card where there is
one; they are skipped, with the reason, only where torch.distributed is
missing. `run_gate()` returns `GateResult`s; the CLI turns any violation
into a non-zero exit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import Contract, check_call

WORLD = 2                  # ranks of the world the dist.* entries run in
WORLD_TIMEOUT_S = 300.0


@dataclass
class GateResult:
    name: str
    violations: List[str] = field(default_factory=list)
    skipped: str = ""          # non-empty reason => entry did not run
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclass(frozen=True)
class Entry:
    name: str
    run: Callable[["Smoke"], List[str]]     # -> violation strings
    min_devices: int = 1
    kernels: tuple = ()        # kernels it must launch on the card
    notes: str = ""


class Smoke:
    """The smoke model of a gate run on one device, built once: qwen2-7b's
    smoke config at f32 compute, its params and their 4-bit packed
    serving form."""

    def __init__(self, device):
        from repro_torch.configs import get_smoke_config
        self.device = torch.device(device)
        self.cfg = get_smoke_config("qwen2-7b").replace(
            compute_dtype="float32")
        self._params = self._serving = None

    @property
    def params(self):
        if self._params is None:
            from repro_torch.models import init_params
            self._params = init_params(self.cfg, seed=0, device=self.device)
        return self._params

    @property
    def serving(self):
        if self._serving is None:
            from repro_torch.core import QuantSpec, quantize_model
            from repro_torch.core.apply import serving_params
            from repro_torch.models import BuildPlan
            gen = np.random.default_rng(0)
            calib = torch.from_numpy(gen.integers(
                0, self.cfg.vocab_size, (4, 40))).to(self.device)
            qparams, _ = quantize_model(self.params, self.cfg, BuildPlan(),
                                        calib, QuantSpec(bits=4),
                                        method="rtn")
            self._serving = serving_params(qparams, self.cfg)
        return self._serving

    def runtime(self, kv_bits: int = 0, mesh=None, slots: int = 2):
        from repro_torch.models import BuildPlan
        from repro_torch.serve import Runtime, ServeConfig
        plan = BuildPlan(remat=False, cache_dtype=torch.float32,
                         kv_bits=kv_bits)
        return Runtime(self.serving, self.cfg, plan,
                       ServeConfig(max_slots=slots, block_size=8,
                                   num_blocks=256, buckets=(8, 16),
                                   max_blocks_per_slot=4),
                       mesh=mesh, device=self.device)


def _decode_violations(rt, name: str) -> List[str]:
    from repro_torch.models.model import decode_step_paged
    from repro_torch.roofline.kv_bytes import decode_step_inputs
    args = (rt.params, rt.cfg, rt.plan, rt.pool,
            *decode_step_inputs(rt, live_tokens=20))
    con = Contract(name=name, collectives=0, inplace=(3,))
    with torch.no_grad():
        return check_call(con, decode_step_paged, *args)


def _check_decode(s: Smoke) -> List[str]:
    return _decode_violations(s.runtime(), "serve.decode_step")


def _check_decode_quant(s: Smoke) -> List[str]:
    return _decode_violations(s.runtime(kv_bits=8), "serve.decode_step_q8")


def _check_decode_quant_tp(s: Smoke) -> List[str]:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(s.device.type if dist.get_backend() == "nccl"
                            else "cpu", (dist.get_world_size(),),
                            mesh_dim_names=("model",))
    return _decode_violations(s.runtime(kv_bits=8, mesh=mesh, slots=4),
                              "serve.decode_step_q8_tp")


def _check_prefill(s: Smoke) -> List[str]:
    """One bucket's prefill through its graph (`serve.prefill[bucket]`)."""
    rt = s.runtime()
    bucket = rt.serve_cfg.buckets[0]
    con = Contract(name="serve.prefill", collectives=0)
    with torch.no_grad():
        return check_call(con, rt._prefill_fn(bucket),
                          rt._upload(np.zeros((1, bucket), np.int64)),
                          rt._upload(np.asarray(bucket, np.int64)))


def _check_prefill_write(s: Smoke) -> List[str]:
    """The bucket's rows written through the write graph
    (`serve.prefill_write[cache_len]`), the pool its held argument."""
    rt = s.runtime()
    bucket = rt.serve_cfg.buckets[0]
    with torch.no_grad():
        _, k_seq, v_seq, pos, tlen = rt._prefill(np.zeros(bucket, np.int64),
                                                 bucket)
        write = rt._write_fn(int(k_seq.shape[1]))
        table = rt._upload(np.arange(rt.maxb, dtype=np.int32))
        con = Contract(name="serve.prefill_write", collectives=0,
                       inplace=(0,))
        return check_call(con, write.func, *write.args, k_seq, v_seq, pos,
                          tlen, table)


def _check_solver_blocked(s: Smoke) -> List[str]:
    from repro_torch.core.comq_hessian import comq_quantize_blocked
    from repro_torch.core.quantizer import QuantSpec
    m, n = 32, 16
    rng = np.random.default_rng(0)
    h = torch.eye(m, device=s.device) * 2.0
    w = torch.tensor(rng.normal(size=(m, n)), dtype=torch.float32,
                     device=s.device)
    con = Contract(name="solver.comq_blocked", collectives=0)
    return check_call(con, comq_quantize_blocked, h, w, QuantSpec(bits=4),
                      block=m)


def _check_train_step(s: Smoke) -> List[str]:
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import BuildPlan
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = s.cfg.replace(compute_dtype="bfloat16")
    run_cfg = RunConfig(arch="qwen2-7b", total_steps=10)
    adamw = AdamWConfig(weight_decay=run_cfg.weight_decay)
    step = make_train_step(cfg, BuildPlan(remat=False), run_cfg, adamw)
    state = init_train_state(s.params, adamw, run_cfg)
    batch = {"tokens": torch.zeros(2, 16, dtype=torch.long,
                                   device=s.device),
             "labels": torch.zeros(2, 16, dtype=torch.long,
                                   device=s.device)}
    con = Contract(name="train.step", inplace=(0,))
    return check_call(con, step, state, batch)


def _check_dist_solve(s: Smoke) -> List[str]:
    import torch.distributed as dist

    from repro_torch.core.comq_hessian import shared_order
    from repro_torch.core.quantizer import QuantSpec
    from repro_torch.dist.calibrate import _local_solve
    from repro_torch.dist.sharding import column_slice
    spec = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=2,
                     order="cyclic")
    m, n = 64, 96
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(256, m)), dtype=torch.float32,
                     device=s.device)
    h = x.T @ x / 256
    w = torch.tensor(rng.normal(size=(m, n)), dtype=torch.float32,
                     device=s.device)
    lo, hi, _ = column_slice(n, dist.get_rank(), dist.get_world_size())
    perm = shared_order(h, w, spec)
    con = Contract(name="dist.solve", collectives=0)
    return check_call(con, _local_solve, h, w[:, lo:hi].contiguous(), perm,
                      spec, "comq_blocked", 32)


def _check_dist_gram(s: Smoke) -> List[str]:
    import torch.distributed as dist

    from repro_torch.dist.calibrate import data_mesh, sharded_gram
    mesh = data_mesh()
    tap = torch.ones(4 * dist.get_world_size(), 3, 16, device=s.device)
    con = Contract(name="dist.gram", collectives={"all_reduce": 1},
                   notes="one all-reduce a tap Gram")
    return check_call(con, sharded_gram, mesh, tap)


_DECODE = ("paged_attention", "quant_matmul")
_DECODE_Q = ("paged_attention_quant", "quant_matmul")
ENTRIES: Dict[str, Entry] = {e.name: e for e in (
    Entry("serve.decode_step", _check_decode, kernels=_DECODE,
          notes="pool updated in place, zero collectives"),
    Entry("serve.decode_step_q8", _check_decode_quant, kernels=_DECODE_Q,
          notes="int8 pages + per-page scales: pool updated in place, "
                "zero collectives, dequant inside the attention kernel"),
    Entry("serve.decode_step_q8_tp", _check_decode_quant_tp, min_devices=2,
          kernels=_DECODE_Q,
          notes="slot+page-sharded quantized decode over a model axis: "
                "still zero collectives, the rank's pool in place"),
    Entry("serve.prefill", _check_prefill, kernels=("flash_attention",),
          notes="zero collectives"),
    Entry("serve.prefill_write", _check_prefill_write,
          notes="pool updated in place through the scatter"),
    Entry("solver.comq_blocked", _check_solver_blocked,
          kernels=("comq_panel",), notes="zero collectives"),
    Entry("train.step", _check_train_step,
          kernels=("flash_attention", "flash_attention_bwd"),
          notes="train state updated in place"),
    Entry("dist.solve", _check_dist_solve, min_devices=2,
          kernels=("comq_panel",),
          notes="zero-communication column-sharded solve"),
    Entry("dist.gram", _check_dist_gram, min_devices=2,
          notes="exactly one all-reduce per Gram tap"),
)}


def _run_entry(entry: Entry, smoke: Smoke) -> GateResult:
    """One entry in this process: its violations, its launches and, on
    the card, the kernels it failed to launch."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    try:
        viol = entry.run(smoke)
    except Exception as e:            # a broken entry is a failure
        viol = [f"[{entry.name}] gate entry raised: "
                f"{type(e).__name__}: {e}"]
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if smoke.device.type == "cuda":
        viol += [f"[{entry.name}] launched no {k} kernel on the card"
                 for k in entry.kernels if not launches.get(k)]
    return GateResult(entry.name, viol, launches=launches)


def _run_world(names: Sequence[str], device: torch.device
               ) -> List[GateResult]:
    """The named entries on every rank of a gloo world of WORLD ranks;
    an entry's violations are every rank's."""
    import torch.distributed as dist
    if not dist.is_available():
        return [GateResult(n, skipped="torch.distributed is not available")
                for n in names]
    with tempfile.TemporaryDirectory(prefix="comq_gate_") as work:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(Path(__file__).resolve().parents[2])]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env.setdefault("OMP_NUM_THREADS", "1")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={WORLD}", "-m",
               "repro_torch.analysis.registry", work, str(device),
               *names]
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=WORLD_TIMEOUT_S)
        ranks = []
        for r in range(WORLD):
            path = Path(work) / f"rank{r}.json"
            if path.exists():
                ranks.append(json.loads(path.read_text()))
    if proc.returncode != 0 or len(ranks) != WORLD:
        tail = (proc.stderr or proc.stdout)[-2000:]
        return [GateResult(n, [f"[{n}] the world of {WORLD} exited "
                               f"{proc.returncode}: {tail}"])
                for n in names]
    out = []
    for n in names:
        viol = [v for rank in ranks for v in rank[n]["violations"]]
        launches = {}
        for rank in ranks:
            for k, v in rank[n]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        out.append(GateResult(n, viol, launches=launches))
    return out


def run_gate(names: Optional[Sequence[str]] = None,
             device=None) -> List[GateResult]:
    """Run the named entries (default: all) on `device` (default: the
    card); the min_devices=2 entries in one world of WORLD ranks."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    names = list(names or sorted(ENTRIES))
    smoke = Smoke(dev)
    local = [n for n in names if ENTRIES[n].min_devices <= 1]
    results = {n: _run_entry(ENTRIES[n], smoke) for n in local}
    world = [n for n in names if ENTRIES[n].min_devices > 1]
    if world:
        results.update({r.name: r for r in _run_world(world, dev)})
    return [results[n] for n in names]


def world_main(argv) -> int:
    """One rank of the dist.* entries' world: `python -m
    torch.distributed.run --standalone --nproc-per-node 2 -m
    repro_torch.analysis.registry OUT_DIR DEVICE NAME...`."""
    import torch.distributed as dist

    from repro_torch.dist import world
    out_dir, device, *names = argv
    torch.set_num_threads(1)
    dev, started = world.init_world("gloo", device)
    smoke = Smoke(dev)
    res = {}
    for n in names:
        r = _run_entry(ENTRIES[n], smoke)
        res[n] = {"violations": [f"rank {dist.get_rank()}: {v}"
                                 for v in r.violations],
                  "launches": r.launches}
    path = Path(out_dir) / f"rank{dist.get_rank()}.json"
    path.write_text(json.dumps(res))
    world.close_world(started)
    return 0


if __name__ == "__main__":
    sys.exit(world_main(sys.argv[1:]))
