"""Per-leaf mixed-precision policies and the budgeted bit allocator (port
of `repro.core.policy`).

A `QuantPolicy` resolves a (layer, leaf-name) pair to its own QuantSpec:

1. pattern ``rules``, first match wins, matched against the
   layer-qualified name ``"{layer}.{name}"`` first, then the bare leaf name
   (fnmatch wildcards, e.g. ``("*.w_down", 8)``);
2. ``first_layer_bits`` / ``last_layer_bits`` (layer 0 / n_layers-1);
3. ``base.bits``.

Only the bit width varies per leaf; granularity, order, λ and sweeps are
policy-wide, so a uniform policy is bit-identical to the plain QuantSpec
path. `policy_from_budget` derives an exact per-leaf assignment from a
bits-per-param budget with a greedy knapsack over the layerwise H-space
errors (`allocate_bits`), measured by `measure_bit_curves` from one float
forward per layer — no backprop.

The pure part (resolution, parsing, the allocator) is plain Python and
gives exactly the JAX package's results; a VLM cross layer's leaves
resolve under their "cross." names ("cross.mlp.w_down", "9.cross.*").
The curve measurement covers the dense (and audio), MoE, hybrid and RWKV
families (an expert leaf priced for all its experts in one batched pass;
a hybrid or RWKV walk carries its recurrent state from layer to layer as
the JAX one does); for a VLM it raises, as the JAX package's does (its
policies are resolved from explicit rules).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.quantizer import QuantSpec, codes_per_byte

#: bit widths the allocator may assign (each has a packed storage form:
#: 2 -> 0.25 B, 3/4 -> 0.5 B, 8 -> 1 B a parameter)
DEFAULT_BIT_CHOICES = (2, 3, 4, 8)


@dataclass(frozen=True)
class QuantPolicy:
    """A policy resolved per leaf. ``rules`` are ``(pattern, bits)``
    pairs; ``kv_bits`` is the KV-cache precision the deployment should use
    (0 = the plan's cache dtype, 8 = int8, 4 = 4-bit pages) and does not
    affect weight solves."""
    base: QuantSpec = QuantSpec()
    rules: Tuple[Tuple[str, int], ...] = ()
    first_layer_bits: Optional[int] = None
    last_layer_bits: Optional[int] = None
    kv_bits: int = 0

    def resolve(self, name: str, layer: int, n_layers: int) -> QuantSpec:
        """The spec for leaf `name` ("attn.wq", "mlp.w_down", "unembed",
        ...) of layer `layer` (-1 for leaves outside the layers)."""
        qualified = f"{layer}.{name}"
        for pattern, bits in self.rules:
            if fnmatchcase(qualified, pattern) or fnmatchcase(name, pattern):
                return dataclasses.replace(self.base, bits=int(bits))
        if self.first_layer_bits is not None and layer == 0:
            return dataclasses.replace(self.base,
                                       bits=int(self.first_layer_bits))
        if self.last_layer_bits is not None and layer == n_layers - 1:
            return dataclasses.replace(self.base,
                                       bits=int(self.last_layer_bits))
        return self.base

    def is_uniform(self) -> bool:
        return (not self.rules and self.first_layer_bits is None
                and self.last_layer_bits is None)


def as_policy(spec_or_policy) -> QuantPolicy:
    """Wrap a plain QuantSpec into the uniform policy it denotes."""
    if isinstance(spec_or_policy, QuantPolicy):
        return spec_or_policy
    if isinstance(spec_or_policy, QuantSpec):
        return QuantPolicy(base=spec_or_policy)
    raise TypeError(
        f"expected QuantSpec or QuantPolicy, got {type(spec_or_policy)}")


def parse_policy(text: str, base: QuantSpec) -> QuantPolicy:
    """Parse the launcher's ``--policy`` string: comma-separated
    ``pattern=bits`` rules plus the shorthands ``first=b`` / ``last=b`` /
    ``kv=b`` (e.g. ``"*.w_down=8,first=8,last=8,kv=8"``)."""
    rules: List[Tuple[str, int]] = []
    first = last = None
    kv = 0
    for item in filter(None, (s.strip() for s in text.split(","))):
        key, _, val = item.partition("=")
        if not val:
            raise ValueError(f"policy rule {item!r} is not 'pattern=bits'")
        bits = int(val)
        if key == "first":
            first = bits
        elif key == "last":
            last = bits
        elif key == "kv":
            kv = bits
        else:
            rules.append((key, bits))
    return QuantPolicy(base=base, rules=tuple(rules), first_layer_bits=first,
                       last_layer_bits=last, kv_bits=kv)


def policy_to_dict(policy: QuantPolicy) -> dict:
    """JSON- and checkpoint-safe metadata form (the JAX package's)."""
    return {
        "base": dataclasses.asdict(policy.base),
        "rules": [[p, int(b)] for p, b in policy.rules],
        "first_layer_bits": policy.first_layer_bits,
        "last_layer_bits": policy.last_layer_bits,
        "kv_bits": policy.kv_bits,
    }


def policy_from_dict(d: dict) -> QuantPolicy:
    return QuantPolicy(
        base=QuantSpec(**d["base"]),
        rules=tuple((p, int(b)) for p, b in d.get("rules", ())),
        first_layer_bits=d.get("first_layer_bits"),
        last_layer_bits=d.get("last_layer_bits"),
        kv_bits=d.get("kv_bits", 0),
    )


# ---------------------------------------------------------------------------
# budgeted bit allocation (greedy knapsack on layerwise H-space errors)
# ---------------------------------------------------------------------------

def allocate_bits(curves: Dict[str, Dict[int, float]],
                  sizes: Dict[str, int],
                  budget_bits_per_param: float,
                  choices: Sequence[int] = DEFAULT_BIT_CHOICES
                  ) -> Dict[str, int]:
    """Greedy budgeted allocation: every leaf starts at min(choices); the
    upgrade with the best error reduction per extra bit·param is applied
    until the next one would exceed the budget.

    Curves are first clipped monotone non-increasing in bits; each leaf's
    upgrade steps are convexified (a later step with a strictly better
    gain/cost ratio merges with its predecessor), sorted once by ratio
    (budget-independent, ties by leaf then bits) and applied as a strict
    prefix — so a larger budget's allocation contains a smaller one's and
    total error is non-increasing in the budget. The assignment never
    exceeds the budget."""
    choices = sorted(set(int(c) for c in choices))
    if not choices:
        raise ValueError("allocate_bits needs at least one bit choice")
    leaves = sorted(curves)
    if set(leaves) != set(sizes):
        raise ValueError("curves and sizes must cover the same leaves")

    # monotone envelope: err at b = min err over widths <= b in the curve
    mono: Dict[str, Dict[int, float]] = {}
    for leaf in leaves:
        best = float("inf")
        mono[leaf] = {}
        for b in choices:
            if b not in curves[leaf]:
                raise ValueError(f"curve for {leaf!r} missing bits={b}")
            best = min(best, float(curves[leaf][b]))
            mono[leaf][b] = best

    alloc = {leaf: choices[0] for leaf in leaves}
    total_params = sum(sizes.values())
    budget_bits = budget_bits_per_param * total_params
    spent = float(choices[0]) * total_params
    if spent > budget_bits + 1e-9:
        raise ValueError(
            f"budget {budget_bits_per_param} bits/param is below the "
            f"smallest choice {choices[0]}")

    ups = []
    for leaf in leaves:
        steps = []
        for lo, hi in zip(choices, choices[1:]):
            steps.append([(hi - lo) * sizes[leaf],
                          mono[leaf][lo] - mono[leaf][hi], hi])
            while (len(steps) >= 2 and steps[-1][1] * steps[-2][0]
                   > steps[-2][1] * steps[-1][0]):
                c2, g2, h2 = steps.pop()
                c1, g1, _ = steps.pop()
                steps.append([c1 + c2, g1 + g2, h2])
        for cost, gain, hi in steps:
            ups.append((-(gain / cost), leaf, hi, cost))
    ups.sort(key=lambda t: (t[0], t[1], t[2]))

    for _, leaf, hi, cost in ups:
        if spent + cost > budget_bits + 1e-9:
            break
        alloc[leaf] = hi
        spent += cost
    return alloc


def alloc_bits_per_param(alloc: Dict[str, int], sizes: Dict[str, int]
                         ) -> float:
    total = sum(sizes.values())
    return sum(alloc[l] * sizes[l] for l in alloc) / max(total, 1)


def alloc_bytes_per_param(alloc: Dict[str, int], sizes: Dict[str, int]
                          ) -> float:
    """Packed storage cost of an allocation (codes only, without the
    per-channel scale and zero-point)."""
    total = sum(sizes.values())
    return sum(sizes[l] / codes_per_byte(alloc[l])
               for l in alloc) / max(total, 1)


# ---------------------------------------------------------------------------
# curve measurement: one float forward per layer, zero backprop
# ---------------------------------------------------------------------------

def measure_bit_curves(params, cfg, plan, tokens, base: QuantSpec,
                       choices: Sequence[int] = DEFAULT_BIT_CHOICES,
                       curve_method: str = "rtn",
                       include_unembed: bool = False):
    """Per-leaf error-vs-bits curves from the taps of one float-model walk
    (the legacy schedule's tap forward, without its second forward).

    curve_method="rtn" (default) prices each width with the H-space error
    of the COMQ grid init (one H·R product per (leaf, width));
    "comq_blocked" runs the blocked solve per width instead.

    Returns (curves, sizes): {name: {bits: err}}, {name: n_params} with
    layer-qualified names ("3.attn.wq", "unembed")."""
    from repro_torch.core import calibrate, pipeline
    from repro_torch.core.baselines import rtn_quantize
    from repro_torch.core.comq_hessian import (
        comq_quantize_blocked, comq_quantize_blocked_experts, per_expert,
        rtn_experts)
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import apply_norm
    from repro_torch.models.model import embed_tokens

    try:
        tfm.check_ported(cfg)
    except NotImplementedError as e:
        raise NotImplementedError(f"measure_bit_curves: {e}") from e
    if cfg.family == "vlm":
        raise NotImplementedError(
            "bit-curve measurement covers homogeneous stacks; resolve VLM "
            "policies with explicit rules instead")

    def leaf_errs(h, w2d):
        out = {}
        for b in choices:
            spec_b = dataclasses.replace(base, bits=int(b))
            if curve_method == "comq_blocked":
                r = comq_quantize_blocked(h, w2d, spec_b)
            else:
                r = rtn_quantize(w2d, spec_b, h=h)
            out[int(b)] = r.errors[-1]
        return out

    def expert_errs(hs, w):
        """A stacked-expert leaf: each width priced for all experts in
        one batched pass, the per-expert error norms summed (the
        pipeline's MoE error)."""
        out = {}
        for b in choices:
            spec_b = dataclasses.replace(base, bits=int(b))
            if curve_method == "comq_blocked":
                e = comq_quantize_blocked_experts(hs, w, spec_b).errors[:, -1]
            else:
                rt = rtn_experts(w, spec_b)
                r = w - rt.q.float() * per_expert(rt.delta)
                e = torch.sqrt(torch.clamp(torch.sum(
                    r * torch.bmm(hs, r), dim=(1, 2)), min=0.0))
            out[int(b)] = torch.sum(e)
        return out

    sizes: Dict[str, int] = {}
    pending: List[Tuple[str, Dict[int, torch.Tensor]]] = []
    tapmap = pipeline.taps_for(cfg)
    with torch.no_grad():
        x = embed_tokens(params, cfg, plan, tokens)
        state = None
        for l, lp in enumerate(params["layers"]):
            taps: Dict[str, torch.Tensor] = {}
            x, state = pipeline.layer_with_state(lp, x, state, cfg, plan,
                                                 taps=taps)
            for tapname, entries in pipeline._tap_groups(lp, tapmap).items():
                if tapname.startswith("expert"):
                    hs = calibrate.batched_gram(taps[tapname])
                    for mod, leaf in entries:
                        w = lp[mod][leaf].float()          # (E, d, f)
                        name = f"{l}.{mod}.{leaf}"
                        sizes[name] = int(w.numel())
                        pending.append((name, expert_errs(hs, w)))
                    continue
                h = calibrate.gram_from_tap(taps[tapname])
                for mod, leaf in entries:
                    w2d = pipeline._w2d(lp[mod][leaf], h.shape[0]).float()
                    name = f"{l}.{mod}.{leaf}"
                    sizes[name] = int(w2d.numel())
                    pending.append((name, leaf_errs(h, w2d)))
        if include_unembed and "unembed" in params:
            xn = apply_norm(params["final_norm"], x, cfg)
            h = calibrate.gram_from_tap(xn)
            w2d = params["unembed"].float()
            sizes["unembed"] = int(w2d.numel())
            pending.append(("unembed", leaf_errs(h, w2d)))

    # one transfer for all the device scalars
    vals = torch.stack([v.float() for _, d in pending
                        for v in d.values()]).cpu().tolist()
    curves: Dict[str, Dict[int, float]] = {}
    i = 0
    for name, d in pending:
        curves[name] = {}
        for b in d:
            curves[name][int(b)] = float(vals[i])
            i += 1
    return curves, sizes


def policy_from_budget(params, cfg, plan, tokens, base: QuantSpec,
                       budget_bits_per_param: float,
                       choices: Sequence[int] = DEFAULT_BIT_CHOICES,
                       curve_method: str = "rtn",
                       kv_bits: int = 0):
    """Measure curves, allocate under the budget, and emit a QuantPolicy
    whose rules pin every leaf exactly (base.bits = the modal choice, so
    the rule list stays short). Returns (policy, alloc, sizes)."""
    curves, sizes = measure_bit_curves(params, cfg, plan, tokens, base,
                                       choices=choices,
                                       curve_method=curve_method)
    alloc = allocate_bits(curves, sizes, budget_bits_per_param,
                          choices=choices)
    counts: Dict[int, int] = {}
    for b in alloc.values():
        counts[b] = counts.get(b, 0) + 1
    modal = max(counts, key=lambda b: (counts[b], -b))
    rules = tuple((name, b) for name, b in sorted(alloc.items())
                  if b != modal)
    policy = QuantPolicy(base=dataclasses.replace(base, bits=modal),
                         rules=rules, kv_bits=kv_bits)
    return policy, alloc, sizes
