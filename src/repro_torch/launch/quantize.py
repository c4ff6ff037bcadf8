"""COMQ quantization launcher (port of `repro.launch.quantize`):
calibrate → quantize → pack, then the fp and quantized eval loss.

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch qwen2-7b \
        --smoke --method comq_blocked --bits 4 --device cpu

Runs on the card unless `--device cpu` is given. Prints the JAX
launcher's JSON summary keys (data_shards/model_shards are 1: the port
runs on one device). Flags of the JAX launcher that this port does not
have yet exit with a message saying so; none is silently ignored.
`quantize_and_eval` is the same run as a function of a ModelConfig.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.ckpt import pack_tree, save_packed_ckpt, tree_bytes
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import QuantSpec, materialize, quantize_model
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import BuildPlan, init_params, lm_loss

# JAX launcher flags not ported yet, with whether each takes a value
NOT_PORTED = {"--propagation": True, "--shard-data": False,
              "--shard-solve": True, "--policy": True, "--bits-budget": True,
              "--out-dir": True, "--journal": True, "--resume": False,
              "--restarts": True, "--inject": True, "--no-guards": False,
              "--trace": True, "--metrics": True}


def set_precision() -> None:
    """Full-f32 matmuls and convolutions on the card (no TF32): Grams and
    the solver's trailing updates are f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class QuantizeRun:
    summary: Dict[str, Any]
    params: Any
    qparams: Any
    report: Any
    spec: QuantSpec
    calib_tokens: torch.Tensor
    eval_tokens: torch.Tensor


def _randint(seed: int, shape, high: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, high, shape, generator=gen, device=dev)


def quantize_and_eval(cfg, *, bits: int = 4,
                      granularity: str = "per_channel",
                      order: str = "greedy", sweeps: int = 3,
                      lam: float = 0.9, method: str = "comq",
                      calib_batch: int = 8, calib_seq: int = 128,
                      save_packed: Optional[str] = None,
                      device: DeviceLike = None) -> QuantizeRun:
    """Init `cfg` from seed 0, quantize it on random calibration ids
    (seed 0), and evaluate fp vs quantized loss on a held-out batch
    (seed 7) — the JAX launcher's run."""
    dev = resolve_device(device)
    set_precision()
    plan = BuildPlan()
    params = init_params(cfg, seed=0, device=dev)
    tokens = _randint(0, (calib_batch, calib_seq), cfg.vocab_size, dev)
    spec = QuantSpec(bits=bits, granularity=granularity, lam=lam,
                     sweeps=sweeps, order=order)
    t0 = time.time()
    qparams, report = quantize_model(params, cfg, plan, tokens, spec,
                                     method=method)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    packed = pack_tree(qparams["__qlayers__"])
    if save_packed:
        save_packed_ckpt(save_packed, packed, arch=cfg.name, bits=bits)

    ev = _randint(7, (calib_batch, calib_seq), cfg.vocab_size, dev)
    batch = {"tokens": ev, "labels": ev}
    with torch.no_grad():
        fp_loss = float(lm_loss(params, cfg, plan, batch)[0])
        q_loss = float(lm_loss(materialize(qparams, cfg), cfg, plan,
                               batch)[0])
    dense_bytes = tree_bytes(params)
    summary = {
        "arch": cfg.name, "method": method, "bits": bits,
        "mixed_policy": False, "bits_budget": None,
        "propagation": "staged", "data_shards": 1, "model_shards": 1,
        "order": order, "granularity": granularity,
        "layers_quantized": len(report.layers),
        "comq_vs_rtn_error_improvement": round(report.total_improvement(), 4),
        "fp_loss": round(fp_loss, 4), "quant_loss": round(q_loss, 4),
        "seconds": round(dt, 1),
        "ckpt_bytes": tree_bytes(packed),
        "dense_bytes": dense_bytes,
        "compression": round(dense_bytes / max(tree_bytes(packed), 1), 1),
        "guard_events": 0, "resumed_leaves": 0, "faults_fired": 0,
    }
    return QuantizeRun(summary, params, qparams, report, spec, tokens, ev)


class NotPorted(argparse.Action):
    """A JAX launcher flag the port does not have yet: exits 2 saying so."""

    def __call__(self, parser, namespace, values, option_string=None):
        jax_prog = parser.prog.replace("repro_torch.", "repro.")
        parser.exit(2, f"{parser.prog}: {option_string} is not yet ported to "
                       "repro_torch (see ROADMAP.md Queue A); run the JAX "
                       f"launcher `{jax_prog}` for it\n")


def add_not_ported(ap: argparse.ArgumentParser, flags: Dict[str, bool]):
    """Register `flags` ({flag: takes a value}) as NotPorted."""
    for flag, takes_value in flags.items():
        ap.add_argument(flag, action=NotPorted,
                        nargs=None if takes_value else 0,
                        help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quantize")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--granularity", default="per_channel",
                    choices=["per_channel", "per_layer"])
    ap.add_argument("--order", default="greedy",
                    choices=["greedy", "cyclic", "greedy_shared"])
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--lam", type=float, default=0.9)
    ap.add_argument("--method", default="comq",
                    choices=["comq", "comq_blocked", "rtn", "gptq"])
    ap.add_argument("--calib-batch", type=int, default=8)
    ap.add_argument("--calib-seq", type=int, default=128)
    ap.add_argument("--save-packed", default=None, metavar="PATH",
                    help="save the packed tree as one atomic checksummed "
                         "file (readable by the JAX package)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    add_not_ported(ap, NOT_PORTED)
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = quantize_and_eval(
        cfg, bits=args.bits, granularity=args.granularity, order=args.order,
        sweeps=args.sweeps, lam=args.lam, method=args.method,
        calib_batch=args.calib_batch, calib_seq=args.calib_seq,
        save_packed=args.save_packed, device=args.device)
    print(json.dumps(run.summary))
    return run.summary


if __name__ == "__main__":
    main()
