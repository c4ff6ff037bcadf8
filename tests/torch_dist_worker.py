"""One rank of the port's distribution tests (imports no JAX, so the card
runs it too):

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/torch_dist_worker.py TASK IN.pkl OUT_DIR

TASK is prims, walk, serve or restore; IN.pkl holds the task's inputs (numpy); each
rank writes its results to OUT_DIR/rank{R}.pkl, which the test reads.
"""
import os
import pickle
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import dist as rd  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import QuantSpec, quantize_model  # noqa: E402
from repro_torch.core.pipeline import is_qtensor  # noqa: E402
from repro_torch.models import BuildPlan, init_params  # noqa: E402

TIMEOUT_S = 240.0
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "barrier", "send",
               "recv", "reduce", "gather", "scatter")


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    return x


def dev_tree(x, dev):
    return torch.utils._pytree.tree_map(
        lambda a: torch.as_tensor(a, device=dev), x)


def prims(inp, dev):
    from repro_torch.core.comq_hessian import comq_quantize_blocked
    from repro_torch.core.pipeline import _solve_group
    out = {}
    mesh_d = rd.data_mesh()
    out["data_mesh"] = rd.mesh_shape(mesh_d)
    out["gram"] = host(rd.sharded_gram(mesh_d, torch.tensor(inp["tap"],
                                                            device=dev)))
    out["bgram"] = host(rd.sharded_batched_gram(
        mesh_d, torch.tensor(inp["etap"], device=dev)))
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        out["odd_gram"] = host(rd.sharded_gram(
            mesh_d, torch.tensor(inp["odd_tap"], device=dev)))
        out["odd_bgram"] = host(rd.sharded_batched_gram(
            mesh_d, torch.tensor(inp["odd_etap"], device=dev)))
    out["warnings"] = [str(w.message) for w in ws]
    g = dev_tree(inp["g"], dev)
    r = dist.get_rank()
    mine = {k: v[r:r + 1] for k, v in g.items()}
    e = rd.init_error_state(mine)
    o1, e1 = rd.compressed_all_reduce(mine, e)
    o2, e2 = rd.compressed_all_reduce(mine, e1)
    out["compressed"] = host([o1, e1, o2, e2])

    mesh = rd.calib_mesh(model=dist.get_world_size())
    out["solve_mesh"] = rd.mesh_shape(mesh)
    out["solves"], out["replicated"] = [], []
    for c in inp["solves"]:
        spec = QuantSpec(**c["spec"])
        h, w = torch.tensor(c["h"], device=dev), torch.tensor(c["w"],
                                                              device=dev)
        q, delta, z_lo, e2b, e2a = rd.sharded_solve(mesh, h, w, spec,
                                                    "comq_blocked",
                                                    block=c["block"])
        out["solves"].append(host([q, delta, z_lo, e2b, e2a]))
        ref = comq_quantize_blocked(h, w, spec, block=c["block"])
        out["replicated"].append(host([ref.q, ref.delta, ref.z_lo,
                                       ref.errors]))
    grp = inp["group"]
    h = torch.tensor(grp["h"], device=dev)
    ws = [torch.tensor(w, device=dev) for w in grp["ws"]]

    def solve_sh(h, w2d, spec, block=256):
        return rd.sharded_solve(mesh, h, w2d, spec, "comq_blocked",
                                block=block)

    for key, bits in (("fused", [grp["spec"]["bits"]] * len(ws)),
                      ("mixed", grp["mixed_bits"])):
        specs = [QuantSpec(**{**grp["spec"], "bits": b}) for b in bits]
        for tag, sh in (("sharded", solve_sh), ("replicated", None)):
            res = _solve_group(ws, h, specs, "comq_blocked", solve_sh=sh)
            out[f"{key}_{tag}"] = [
                host({"codes": qt["codes"], "z_lo": qt["z_lo"],
                      "scale": qt["scale"], "bits": qt["bits"],
                      "err_after": ea}) for qt, _, ea, _ in res]
    return out


def config(arch: str, kw: dict):
    """The smoke config of `arch` with the fields in `kw` replaced; the key
    "capacity_factor" replaces the MoE config's."""
    import dataclasses
    kw = dict(kw)
    cfg = get_smoke_config(arch)
    if "capacity_factor" in kw:
        kw["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=kw.pop("capacity_factor"))
    return cfg.replace(**kw)


def _codes(qparams):
    out = {}
    for lkey, lp in qparams["__qlayers__"].items():
        for mod, leaves in lp.items():
            if not isinstance(leaves, dict) or is_qtensor(leaves):
                continue
            for leaf, qt in leaves.items():
                if is_qtensor(qt):
                    out[f"{lkey}.{mod}.{leaf}"] = host(
                        {k: qt[k] for k in ("codes", "z_lo", "scale")})
    return out


def walk(inp, dev):
    """quantize_model on each arch with the mesh, then (rank 0) without;
    the kept (token, slot) masks of every MoE routing call are recorded."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.obs import MetricsRegistry
    data, model = inp["mesh"]
    mesh = rd.calib_mesh(model=model, data=data)
    kept = []
    orig = moe_mod.slots_for

    def recording(ids, e_pad, capacity, offset=None):
        pos, slot = orig(ids, e_pad, capacity, offset)
        kept.append(host(pos < capacity))
        return pos, slot

    moe_mod.slots_for = recording
    out = {}
    for arch, a in inp["archs"].items():
        cfg = config(arch, a.get("cfg", {}))
        params = (params_from_numpy(a["params"], dev) if a.get("params")
                  is not None else init_params(cfg, seed=0, device=dev))
        tok = torch.tensor(a["tokens"], device=dev).long()
        spec = QuantSpec(**inp["spec"])
        runs = [("mesh", mesh)] + ([("single", None)]
                                   if dist.get_rank() == 0 else [])
        for tag, m in runs:
            reg = MetricsRegistry()
            del kept[:]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                qp, rep = quantize_model(params, cfg, BuildPlan(), tok, spec,
                                         method=inp["method"], mesh=m,
                                         metrics=reg)
            out[(arch, tag)] = {
                "codes": _codes(qp),
                "rows": [(r.layer, r.name, r.err_before, r.err_after)
                         for r in rep.layers],
                "guard_events": len(rep.guard_events),
                "bytes": reg.counter("dist.bytes_all_reduced").value,
                "kept": list(kept)}
    moe_mod.slots_for = orig
    return out


def serve(inp, dev):
    """Runtime(mesh=) over a ("model",) mesh of the world; collectives are
    counted inside decode_step_paged and outside it."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serve import Runtime, ServeConfig
    from repro_torch.serve import runtime as rt_mod
    cfg = config(inp["arch"], inp.get("cfg", {}))
    params = (params_from_numpy(inp["params"], dev)
              if inp.get("params") is not None
              else init_params(cfg, seed=0, device=dev))
    counts = {"inside": 0, "outside": 0, "steps": 0}
    state = {"in_step": False}

    def counted(fn):
        def wrapper(*a, **k):
            counts["inside" if state["in_step"] else "outside"] += 1
            return fn(*a, **k)
        return wrapper

    for name in COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, counted(getattr(dist, name)))
    orig_step = rt_mod.decode_step_paged

    def step(*a, **k):
        state["in_step"] = True
        counts["steps"] += 1
        try:
            return orig_step(*a, **k)
        finally:
            state["in_step"] = False

    rt_mod.decode_step_paged = step
    mesh = init_device_mesh(dev.type if dist.get_backend() == "nccl"
                            else "cpu", (dist.get_world_size(),),
                            mesh_dim_names=("model",))
    out = {}
    for kv_bits in inp["kv_bits"]:
        plan = BuildPlan(cache_dtype=getattr(torch, inp["cache_dtype"]),
                         kv_bits=kv_bits)
        counts.update(inside=0, outside=0, steps=0)
        from repro_torch.kernels import paged_attention as paged
        n0 = paged.launches + paged.launches_quant
        rt = Runtime(params, cfg, plan, ServeConfig(**inp["sc"]),
                     device=dev, mesh=mesh)
        toks = rt.generate([np.asarray(p) for p in inp["prompts"]],
                           max_new_tokens=inp["max_new"])
        out[kv_bits] = {"tokens": [t.tolist() for t in toks],
                        "counts": dict(counts),
                        "paged_launches": (paged.launches
                                           + paged.launches_quant - n0),
                        "pool_blocks": int(rt.pool["k"].shape[1])}
    rt_mod.decode_step_paged = orig_step
    if inp.get("kill_dir"):
        # a journaled run killed at its 4th step on every rank, recovered
        from repro_torch.ft import FaultInjector, Journal, SimulatedKill
        from repro_torch.serve import recover_runtime
        plan = BuildPlan(cache_dtype=getattr(torch, inp["cache_dtype"]),
                         kv_bits=inp["kv_bits"][0])
        jd = inp["kill_dir"]
        rt = Runtime(params, cfg, plan, ServeConfig(**inp["sc"]), device=dev,
                     mesh=mesh, injector=FaultInjector({"kill": {4}}),
                     journal=Journal(jd) if dist.get_rank() == 0 else None)
        reqs = [rt.submit(np.asarray(p), max_new_tokens=inp["max_new"])
                for p in inp["prompts"]]
        try:
            rt.run()
            killed = False
        except SimulatedKill:
            killed = True
        rt2, st = recover_runtime(params, cfg, plan, jd,
                                  ServeConfig(**inp["sc"]), device=dev,
                                  mesh=mesh)
        replayed = {r.rid: r for r in rt2.scheduler.queue}
        rt2.run()
        out["recovered"] = {"killed": killed,
                            "inflight": sorted(st.inflight),
                            "tokens": [replayed[r.rid].out_tokens
                                       for r in reqs]}
    return out


def restore(inp, dev):
    """restore(shardings=) of the checkpoint in inp["dir"] on a ("data",)
    mesh of the world: each leaf's spec from inp["specs"]; returns each
    rank's local shards and the full tensors."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.dist.sharding import NamedSharding
    mesh = rd.data_mesh()
    like = {k: torch.zeros(v) for k, v in inp["shapes"].items()}
    sh = {k: NamedSharding(mesh, s) for k, s in inp["specs"].items()}
    out, _ = CheckpointManager(inp["dir"]).restore(1, like, shardings=sh)
    return {"local": {k: host(v.to_local()) for k, v in out.items()},
            "full": {k: host(v.full_tensor()) for k, v in out.items()},
            "placements": {k: [str(p) for p in v.placements]
                           for k, v in out.items()}}


def main():
    task, inp_path, out_dir = sys.argv[1:4]
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    backend = sys.argv[5] if len(sys.argv) > 5 else "gloo"
    torch.set_num_threads(1)
    dev, started = rd.init_world(backend, device, timeout_s=TIMEOUT_S)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    out = {"prims": prims, "walk": walk, "serve": serve,
           "restore": restore}[task](inp, dev)
    path = Path(out_dir) / f"rank{dist.get_rank()}.pkl"
    with open(path, "wb") as f:
        pickle.dump(out, f)
    rd.close_world(started)


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()


# ---------------------------------------------------------------------------
# the tests' side: spawn a world on this script and read its ranks back
# ---------------------------------------------------------------------------

def spawn(task: str, inp, n: int, work: Path, device: str = "cpu",
          backend: str = "gloo", timeout: float = 300.0):
    """Run TASK on n ranks (`torch.distributed.run --standalone`, which
    picks a free port) with a subprocess timeout; returns [rank 0's
    results, rank 1's, ...]."""
    import subprocess
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    inp_path = work / f"{task}.in.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    out_dir = work / f"{task}.out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", str(Path(__file__).resolve()), task,
           str(inp_path), str(out_dir), device, backend]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-6000:])
    outs = []
    for r in range(n):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs
