"""The training loop: data, step, checkpoints, watchdog, restart (port of
`repro.train.trainer`).

`Trainer.run_loop()` executes `total_steps` with: sharded batches (a
prefetching `ShardedLoader`), the microbatched train step, periodic async
checkpoints (params + optimizer + loader position), heartbeats, straggler
events (`Watchdog`), and an injectable failure hook (the fault-tolerance
tests' and chip_smoke's). `resume_or_init()` restores the latest
committed checkpoint. Checkpoints are written in the JAX package's layout
(`convert.train_state_to_numpy`: "layers" stacked), so either package's
Trainer resumes the other's.

The step is JAX's compiled program: as JAX's Trainer jits its step with
the state donated, the port's captures it once per signature as a CUDA
graph (`analysis.retrace.guard_graph`, "train.step", one signature a
loop: the batch's shape and dtype with the loop's state held) and
replays it every later step; the step updates the state in place and
returns it, and a resume loads a checkpoint into the same tensors
(`_load_into`), so the graph stays valid. On the CPU the guard runs the
step eagerly and refuses at its first call the ops a capture refuses.

Where JAX's Trainer runs an int8_ef step under a 1-shard `shard_map`, the
port's starts a world of one (`dist.init_world`) for the run when no
process group is up, and all-reduces over it. That all-reduce runs
through host memory (gloo), which a graph cannot hold, so with
`grad_compression="int8_ef"` the step runs eagerly: the configuration
decides, never a failed capture.

Elastic restore: `shard_state_fn(state)` returns the state's shardings (a
tree like the state of `dist.sharding.NamedSharding` on a DeviceMesh, or
None for a leaf), and a resume restores the checkpoint through
`CheckpointManager.restore(shardings=)`, as JAX's Trainer re-shards a
restored state onto another topology. The port's train step is not
GSPMD: it runs on the local tensors. So a sharding that splits a leaf
over a mesh axis larger than one raises, naming the leaf; a world of one
or replicated placements restore DTensors whose local tensors are the
whole leaves, and the step runs on those.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import train_state_to_numpy
from repro_torch.data import ShardedLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft import Heartbeat, Watchdog
from repro_torch.models.model import init_params
from repro_torch.analysis.retrace import guard_graph
from repro_torch.optim import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

_KEEP = np.empty(0)      # a restore template leaf: keep the state's own
BATCH_KEYS = ("tokens", "labels")    # the loader's batch, in call order
STEP_NAME = "train.step"


class Trainer:
    def __init__(self, cfg, plan, run_cfg, *, adamw_cfg: AdamWConfig = None,
                 host_id: int = 0, failure_hook: Optional[Callable] = None,
                 shard_state_fn: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.shard_state_fn = shard_state_fn   # elastic re-shard on restore
        self.cfg = cfg
        self.plan = plan
        self.run = run_cfg
        self.device = resolve_device(device)
        self.adamw_cfg = adamw_cfg or AdamWConfig(
            weight_decay=run_cfg.weight_decay)
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep_ckpts)
        self.watchdog = Watchdog()
        self.heartbeat = Heartbeat(os.path.join(run_cfg.ckpt_dir, "hb"),
                                   host_id)
        self.failure_hook = failure_hook
        self.compress = run_cfg.grad_compression == "int8_ef"
        self.step_fn = make_train_step(cfg, plan, run_cfg, self.adamw_cfg,
                                       group="world" if self.compress
                                       else None)
        self.metrics_log = []

    def direct_step(self, state, *batch):
        """`step_fn` on a batch given as BATCH_KEYS' tensors, eager."""
        return self.step_fn(state, dict(zip(BATCH_KEYS, batch)))

    def _step_program(self):
        """The step `run_loop` calls, `(state, tokens, labels) -> (state,
        metrics)`: `direct_step` under a fresh `guard_graph` (the batch
        copied into its static buffers, the state held; a budget of one
        signature), or `direct_step` itself, eager, for int8_ef."""
        if self.compress:
            return self.direct_step
        return guard_graph(self.direct_step, name=STEP_NAME,
                           device=self.device,
                           copy_argnums=range(1, 1 + len(BATCH_KEYS)),
                           max_signatures=1)

    def init_state(self):
        params = init_params(self.cfg, self.plan, seed=self.run.seed,
                             device=self.device)
        return init_train_state(params, self.adamw_cfg, self.run)

    def resume_or_init(self):
        latest = self.ckpt.latest_step()
        state = self.init_state()
        start_step = 0
        shardings = (_checked_shardings(self.shard_state_fn(state))
                     if self.shard_state_fn else None)
        if latest is not None:
            like = train_state_to_numpy(state, leaf_fn=lambda ls: _KEEP,
                                        one_fn=lambda l: _KEEP)
            saved, meta = self.ckpt.restore(latest, like,
                                            shardings=shardings)
            _load_into(state, saved)
            start_step = meta["step"]
        return state, start_step

    def run_loop(self, total_steps: Optional[int] = None,
                 seq_len: Optional[int] = None,
                 global_batch: Optional[int] = None) -> Dict[str, Any]:
        total = total_steps or self.run.total_steps
        started = False
        if self.compress:
            from repro_torch.dist.world import init_world
            _, started = init_world(device=self.device)
        state, start = self.resume_or_init()
        loader = ShardedLoader(self.cfg.vocab_size,
                               global_batch or 8,
                               seq_len or 128,
                               seed=self.run.seed, start_step=start)
        step = start
        program = self._step_program()
        try:
            while step < total:
                batch = next(loader)
                batch = [torch.from_numpy(batch[k]).to(self.device)
                         for k in BATCH_KEYS]
                self.watchdog.step_start()
                state, metrics = program(state, *batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                ev = self.watchdog.step_end(step)
                if ev is not None:
                    metrics["straggler"] = ev.seconds
                self.metrics_log.append(metrics)
                step += 1
                self.heartbeat.beat(step)
                if self.failure_hook is not None:
                    self.failure_hook(step)   # may raise (injected failure)
                if step % self.run.ckpt_every == 0 or step == total:
                    self.ckpt.save(step, train_state_to_numpy(state),
                                   extra={"loader": loader.state()},
                                   blocking=not self.run.async_ckpt)
        finally:
            loader.close()
            self.ckpt.wait()
            if started:
                from repro_torch.dist.world import close_world
                close_world(started)
        return {"final_step": step, "state": state,
                "metrics": self.metrics_log}


def _stacked_sharding(layers):
    """The sharding of a JAX-layout stacked leaf from its layers' (the
    leading layer axis replicated), or None."""
    from repro_torch.dist.sharding import NamedSharding
    first = layers[0]
    if first is None:
        return None
    return NamedSharding(first.mesh, (None, *first.spec))


def _checked_shardings(shardings):
    """`shard_state_fn`'s shardings in the checkpoint's (JAX) layout;
    raises, naming the leaf, for one that splits a leaf over a mesh axis
    larger than one (the step runs on local tensors, not GSPMD)."""
    from repro_torch.ckpt.checkpoint import flatten_with_paths
    out = train_state_to_numpy(shardings, leaf_fn=_stacked_sharding,
                               one_fn=lambda s: s)
    for key, sh in flatten_with_paths(out).items():
        if sh is not None and sh.splits():
            raise NotImplementedError(
                f"shard_state_fn: {key} is split by {sh!r}; the port's "
                "train step runs on local tensors (not GSPMD), so a "
                "restored leaf must be whole on every rank (replicated, "
                "or split over axes of size one)")
    return out


def _load_into(state, saved) -> None:
    """Copy a restored JAX-layout tree (numpy, or DTensors from an elastic
    restore, each holding its whole leaf) into the port's state in place:
    layer l of a stacked leaf into layer l's tensor; leaves the
    checkpoint predates (restored as the template's `_KEEP`) stay."""
    flat_saved = pytree.tree_leaves(saved)
    flat_dst = pytree.tree_leaves(train_state_to_numpy(
        state, leaf_fn=lambda ls: ls, one_fn=lambda l: l),
        is_leaf=lambda x: isinstance(x, (list, torch.Tensor)))
    if len(flat_saved) != len(flat_dst):
        raise ValueError(f"restored state has {len(flat_saved)} leaves, "
                         f"the train state {len(flat_dst)}")
    for arr, dst in zip(flat_saved, flat_dst):
        if arr is _KEEP:
            continue
        if isinstance(arr, torch.Tensor):
            arr = arr.to_local() if hasattr(arr, "to_local") else arr
        else:
            arr = torch.from_numpy(np.array(arr))
        if isinstance(dst, list):
            for layer, t in enumerate(dst):
                t.copy_(arr[layer])
        else:
            dst.copy_(arr)
