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

Where JAX's Trainer runs an int8_ef step under a 1-shard `shard_map`, the
port's starts a world of one (`dist.init_world`) for the run when no
process group is up, and all-reduces over it. JAX's elastic
`shard_state_fn` re-shard needs `CheckpointManager.restore(shardings=)`,
which the port has with the dry run (ROADMAP item 17): a Trainer given one
refuses it.
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
from repro_torch.optim import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

_KEEP = np.empty(0)      # a restore template leaf: keep the state's own


class Trainer:
    def __init__(self, cfg, plan, run_cfg, *, adamw_cfg: AdamWConfig = None,
                 host_id: int = 0, failure_hook: Optional[Callable] = None,
                 shard_state_fn: Optional[Callable] = None,
                 device: DeviceLike = None):
        if shard_state_fn is not None:
            raise NotImplementedError(
                "shard_state_fn re-shards a restored state with "
                "CheckpointManager.restore(shardings=), which the port does "
                "not have yet (it comes with the dry run, ROADMAP item 17)")
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

    def init_state(self):
        params = init_params(self.cfg, seed=self.run.seed,
                             device=self.device)
        return init_train_state(params, self.adamw_cfg, self.run)

    def resume_or_init(self):
        latest = self.ckpt.latest_step()
        state = self.init_state()
        start_step = 0
        if latest is not None:
            like = train_state_to_numpy(state, leaf_fn=lambda ls: _KEEP,
                                        one_fn=lambda l: _KEEP)
            saved, meta = self.ckpt.restore(latest, like)
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
        try:
            while step < total:
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in next(loader).items()}
                self.watchdog.step_start()
                state, metrics = self.step_fn(state, batch)
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


def _load_into(state, saved) -> None:
    """Copy a restored JAX-layout tree (numpy) into the port's state in
    place: layer l of a stacked leaf into layer l's tensor; leaves the
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
        if isinstance(dst, list):
            for layer, t in enumerate(dst):
                t.copy_(torch.from_numpy(np.array(arr[layer])))
        else:
            dst.copy_(torch.from_numpy(np.array(arr)))
