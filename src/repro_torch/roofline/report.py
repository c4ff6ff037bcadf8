"""Render the roofline table from dry-run artifacts (port of
`repro.roofline.report`), against the H100's figures.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir DIR]

Each artifact is one JSON object with "arch", "shape", "mesh", "memory"
{"per_device_total_gb"} and "hlo" {"flops_per_device",
"bytes_per_device", "collective_bytes"} (or "error"): the JAX dry run's
format. The port's dry run (`launch/dryrun.py`, on the meta device) has no
"hlo": it writes "counted" with the same keys and "collectives_counted":
false, and the table prints n/a in the collective column for such a
cell (nothing was counted there, which is not zero).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline.analysis import H100, CostTotals, roofline_terms

HW_NOTE = ("NVIDIA H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, "
           "NVLink 450 GB/s each way")


def model_flops(arch: str, shape_name: str) -> float:
    """6·N·tokens for a train shape, 2·N·tokens for prefill, 2·N·batch for
    a decode step; N counts an MoE model's active parameters."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.model import param_count
    cfg = get_config(arch)
    s = SHAPES[shape_name]
    n = param_count(cfg, active_only=cfg.moe is not None)
    if s.kind == "train":
        return 6.0 * n * s.global_batch * s.seq_len
    if s.kind == "prefill":
        return 2.0 * n * s.global_batch * s.seq_len
    return 2.0 * n * s.global_batch


def load(dir_):
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        d["_file"] = os.path.basename(path)
        rows.append(d)
    return rows


def fmt_cell(d, hw=H100):
    if "error" in d:
        return None
    h = d.get("hlo") or d.get("counted")
    if not h:
        return None
    chips = 512 if d["mesh"] == "2x16x16" else 256
    cost = CostTotals(flops=h["flops_per_device"],
                      bytes_accessed=h["bytes_per_device"],
                      collective_bytes=h.get("collective_bytes", {}))
    t = roofline_terms(cost, hw)
    collectives = h.get("collectives_counted", True)
    if not collectives:     # unknown, not zero: the bound is a floor
        t = {**t, "collective_s": None}
    mf = model_flops(d["arch"], d["shape"]) / chips
    useful = mf / max(h["flops_per_device"], 1.0)
    roofline_frac = (mf / hw.peak_flops["bf16"]) / max(t["bound_s"], 1e-12)
    return {
        "arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
        "mem_gb": d["memory"]["per_device_total_gb"],
        "compute_s": t["compute_s"], "memory_s": t["memory_s"],
        "collective_s": t["collective_s"],
        "dominant": t["dominant"] if collectives else
        t["dominant"] + " (no collectives counted)",
        "useful": useful, "roofline_frac": roofline_frac,
        "overrides": d.get("overrides") or {},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    print(f"<!-- generated by repro_torch.roofline.report; {HW_NOTE} -->")
    print("| arch | shape | mesh | GB/dev | compute s | memory s | "
          "collective s | dominant | useful-flops | roofline-frac | "
          "overrides |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for d in load(args.dir):
        c = fmt_cell(d)
        if c is None:
            print(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                  f"ERROR: {d.get('error', 'no hlo')[:60]} "
                  f"| | | | | | | |")
            continue
        if args.mesh and c["mesh"] != args.mesh:
            continue
        ov = ",".join(f"{k}={v}" for k, v in c["overrides"].items()) or "-"
        coll = ("n/a" if c["collective_s"] is None
                else f"{c['collective_s']:.4f}")
        print(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
              f"{c['mem_gb']:.2f} | {c['compute_s']:.4f} | "
              f"{c['memory_s']:.4f} | {coll} | "
              f"{c['dominant']} | {c['useful']:.3f} | "
              f"{c['roofline_frac']:.4f} | {ov} |")


if __name__ == "__main__":
    main()
