"""End-to-end training launcher (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --smoke --steps 50 --batch 8 --seq 128 --device cpu

The JAX launcher's flags and its final JSON line (arch, steps, first and
last loss, stragglers), plus `--device`: the run is on the card unless
`--device cpu` is given. `--remat` recomputes each layer in the backward
pass (`BuildPlan.remat`; off unless given, as in the JAX launcher).
`--smoke` runs the reduced config. `train()` runs the launcher's path for a
config it is given: chip_smoke phase 19 trains the full-width qwen2-7b with
its depth cut through it.
Every family the Trainer's token batches feed trains: dense, audio, MoE,
hybrid and RWKV. The VLM (image features) and the encoder (patch
embeddings and class labels) need inputs that no token stream gives, so
the launcher exits 1 and names them (the JAX launcher crashes there).
Checkpoints go to `--ckpt-dir` (default: `repro_train` under the system
temporary directory) in the JAX package's layout, so either package's
Trainer resumes the other's.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import BuildPlan
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "int8"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    return ap


def run_config(args) -> RunConfig:
    """The RunConfig the flags give (the JAX launcher's)."""
    return RunConfig(arch=args.arch, microbatches=args.microbatches,
                     learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)


def check_trainable(cfg) -> None:
    """Exit 1, naming the missing inputs, for a family whose `lm_loss`
    reads more than the Trainer's token batches."""
    if cfg.family == "vlm":
        raise SystemExit(
            f"{cfg.name}: the Trainer feeds token batches, and the VLM's "
            "lm_loss also needs batch['vision_embeds'] (B, "
            f"{cfg.cross_attn.n_vision_tokens}, {cfg.cross_attn.vision_dim}) "
            "image features, which no data source here makes (the JAX "
            "launcher fails in _run_vlm); call models.lm_loss with them "
            "from Python instead")
    if cfg.family == "encoder":
        raise SystemExit(
            f"{cfg.name} is an encoder: its lm_loss needs batch['embeds'] "
            f"(B, T, {cfg.d_model}) patch embeddings and batch['labels'] "
            "(B,) class ids, not token batches (the JAX launcher fails "
            "there); call models.lm_loss with them from Python instead")


def train(cfg, run_cfg: RunConfig, args, failure_hook=None
          ) -> Tuple[Trainer, Dict[str, Any], Dict[str, Any]]:
    """Train `cfg` under `run_cfg` with the flags' steps, batch, sequence,
    moment dtype, remat and device: the launcher's whole run, given a
    config (chip_smoke trains a full-width config with its depth cut).
    Returns (the Trainer, its run_loop result, the final line)."""
    trainer = Trainer(cfg, BuildPlan(remat=args.remat), run_cfg,
                      adamw_cfg=AdamWConfig(moment_dtype=args.moment_dtype),
                      failure_hook=failure_hook, device=args.device)
    out = trainer.run_loop(total_steps=args.steps, seq_len=args.seq,
                           global_batch=args.batch)
    losses = [m["loss"] for m in out["metrics"]]
    line = {"arch": cfg.name, "steps": out["final_step"],
            "first_loss": round(losses[0], 4),
            "last_loss": round(losses[-1], 4),
            "stragglers": len(trainer.watchdog.events)}
    return trainer, out, line


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    from repro_torch.launch.quantize import set_precision
    args = build_parser().parse_args(argv)
    set_precision()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    check_trainable(cfg)
    _, _, line = train(cfg, run_config(args), args)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
