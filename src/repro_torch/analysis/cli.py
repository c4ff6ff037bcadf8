"""`python -m repro_torch.analysis.cli` — the port's static-analysis gate
(port of `repro.analysis.cli`).

Modes (combinable; `--gate` = all three):

* ``--lint``      — AST lint over the port's source (host syncs in hot
  zones, wall clocks in captured code, un-fsynced `os.replace` in the
  durable dirs);
* ``--contracts`` — run every gated entry point of `analysis/registry.py`
  and check its collective census and in-place updates against its
  contract (and, on the card, that it launched its kernels);
* ``--retrace``   — a small mixed-length, staggered serve run under the
  runtime's signature guards, asserting the decode step saw exactly one
  signature and every guard stayed inside its budget.

The entry points run on the card unless `--device cpu`. Exit status is
the number of failed sections (0 = clean), as in JAX. Findings print one
per line; `--quiet` suppresses the per-section OK chatter; `--json PATH`
also writes every section's results there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List


def _print(quiet: bool, msg: str) -> None:
    if not quiet:
        print(msg)


def run_lint(paths: List[str], quiet: bool, out: dict) -> int:
    from repro_torch.analysis.lint import lint_paths
    findings = lint_paths(paths, root=os.getcwd())
    for f in findings:
        print(f)
    out["lint"] = [str(f) for f in findings]
    _print(quiet, f"lint: {len(findings)} finding(s) over {paths}")
    return 1 if findings else 0


def run_contracts(quiet: bool, device, out: dict) -> int:
    from repro_torch.analysis.registry import run_gate
    bad = 0
    out["contracts"] = {}
    for res in run_gate(device=device):
        out["contracts"][res.name] = {"violations": res.violations,
                                      "skipped": res.skipped,
                                      "launches": res.launches}
        if res.skipped:
            _print(quiet, f"contract {res.name}: SKIP ({res.skipped})")
        elif res.ok:
            _print(quiet, f"contract {res.name}: OK (launches "
                          f"{res.launches})")
        else:
            bad += 1
            for v in res.violations:
                print(f"contract {res.name}: {v}")
    return 1 if bad else 0


def run_retrace_smoke(quiet: bool, device=None, out=None) -> int:
    """Mixed-length, staggered serve run; the decode step must see exactly
    one signature and every runtime guard must stay inside its budget."""
    import numpy as np
    import torch

    from repro_torch.analysis.registry import Smoke
    from repro_torch.analysis.retrace import (compile_count,
                                              guard_violations,
                                              reset_guards, retrace_report)
    from repro_torch.device import resolve_device
    from repro_torch.models import BuildPlan
    from repro_torch.serve import Runtime, ServeConfig

    reset_guards()
    smoke = Smoke(resolve_device(device))
    cfg = smoke.cfg
    rt = Runtime(smoke.serving, cfg,
                 BuildPlan(remat=False, cache_dtype=torch.float32),
                 ServeConfig(max_slots=3, block_size=8, num_blocks=24,
                             buckets=(8, 16), max_blocks_per_slot=4),
                 device=smoke.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(L,)).astype(np.int32)
               for L in (5, 11, 7, 13)]
    problems: List[str] = []
    try:
        # staggered arrivals: two up front, two injected mid-run
        for p in prompts[:2]:
            rt.submit(p, max_new_tokens=6)
        rt.step()
        rt.step()
        rt.submit(prompts[2], max_new_tokens=5, temperature=0.7, seed=7)
        rt.step()
        rt.submit(prompts[3], max_new_tokens=4)
        rt.run()
    except Exception as e:   # strict mode raises mid-run on violation
        problems.append(f"serve run raised: {type(e).__name__}: {e}")
    n = compile_count("serve.decode_step")
    if n != 1:
        problems.append(f"decode step saw {n} signature(s), expected "
                        "exactly 1 across a mixed/staggered run")
    problems += guard_violations()
    for p in problems:
        print(f"retrace: {p}")
    report = retrace_report()
    traced = {k: v["traces"] for k, v in report.items() if v["traces"]}
    if out is not None:
        out["retrace"] = {"signatures": traced, "problems": problems}
    if not problems:
        _print(quiet, f"retrace: OK — signatures {traced}")
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli",
        description="contract + lint gate of the PyTorch port")
    ap.add_argument("--gate", action="store_true",
                    help="run every check (lint + contracts + retrace)")
    ap.add_argument("--lint", action="store_true")
    ap.add_argument("--contracts", action="store_true")
    ap.add_argument("--retrace", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--json", default=None,
                    help="also write every section's results here")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("paths", nargs="*", default=None,
                    help="lint roots (default: src/repro_torch)")
    args = ap.parse_args(argv)
    if args.gate:
        args.lint = args.contracts = args.retrace = True
    if not (args.lint or args.contracts or args.retrace):
        ap.error("pick at least one of --gate/--lint/--contracts/--retrace")

    failures = 0
    out: dict = {}
    if args.lint:
        failures += run_lint(args.paths or ["src/repro_torch"], args.quiet,
                             out)
    if args.contracts:
        failures += run_contracts(args.quiet, args.device, out)
    if args.retrace:
        failures += run_retrace_smoke(args.quiet, args.device, out)
    out["failures"] = failures
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    _print(args.quiet,
           "analysis gate: " + ("CLEAN" if not failures
                                else f"{failures} section(s) FAILED"))
    return failures


if __name__ == "__main__":
    sys.exit(main())
