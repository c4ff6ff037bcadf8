"""Numeric guards for the quantization pipeline (port of
`repro.core.guards`).

* **Sentinels** — `sanitize_array` / `gram_health` count NaN/Inf entries
  (and zero Gram diagonals, i.e. dead input columns) with one small host
  read, and zero non-finite values only when they found some, so a healthy
  guarded run gives the unguarded run's codes bit for bit.
* **Escalating diagonal damping** — `damp_hessian(h, mult)` adds
  `mult · mean(diag H) · I`; a failed solve walks `DAMP_MULTS` after an
  undamped attempt. `damped_inverse` is the variant the GPTQ baseline
  uses: it re-inverts under 10× stronger damping until H⁻¹ is finite.
* **Fallback chain** — `guarded_solve` retries a failed solve through
  `solver_chain(method)` (comq_blocked: trailing → refresh → RTN;
  comq/gptq: → RTN), escalating damping within each stage, and ends at
  data-free RTN, which is finite by construction. Every escalation and
  fallback is a `GuardEvent` on the `GuardContext` and a warning.

On a card each sentinel and `result_ok` is one scalar read, so one host
sync, per tap group or solve.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.quantizer import EPS, QuantSpec

Tensor = torch.Tensor

# escalation schedule, as multiples of mean(diag H); an undamped attempt
# always runs first
DAMP_MULTS = (1e-4, 1e-2, 1e-1, 1.0)

# a solve whose final H-space error exceeds this multiple of the data-free
# RTN error on the same grid has diverged, even if finite
EXPLODE_FACTOR = 10.0


@dataclass
class GuardEvent:
    """One guard intervention, keyed to the leaf it protected."""
    layer: int
    name: str
    kind: str            # nonfinite_tap | nonfinite_gram | nonfinite_weight
    #                    | dead_columns | damping_escalated | fallback
    detail: Dict[str, Any] = field(default_factory=dict)


class GuardContext:
    """Collects GuardEvents across one quantize_model walk. A disabled
    context makes every guard hook a no-op."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[GuardEvent] = []

    def record(self, layer: int, name: str, kind: str, warn: bool = True,
               **detail) -> GuardEvent:
        ev = GuardEvent(int(layer), str(name), kind, dict(detail))
        self.events.append(ev)
        if warn:
            warnings.warn(
                f"quantization guard [{kind}] layer {layer} leaf {name}: "
                f"{detail}", stacklevel=3)
        return ev

    def by_leaf(self) -> Dict[Tuple[int, str], str]:
        """(layer, name) -> comma-joined distinct event kinds."""
        out: Dict[Tuple[int, str], List[str]] = {}
        for e in self.events:
            kinds = out.setdefault((e.layer, e.name), [])
            if e.kind not in kinds:
                kinds.append(e.kind)
        return {k: ",".join(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# sentinels
# ---------------------------------------------------------------------------

def nonfinite_count(x: Tensor) -> int:
    """Number of NaN/Inf entries (one scalar read)."""
    # comq: allow(host-sync) sentinel: one small intentional read
    return int(torch.sum(~torch.isfinite(x)))


def zero_nonfinite(x: Tensor) -> Tensor:
    """x with its NaN/Inf entries set to 0."""
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def sanitize_array(x: Tensor) -> Tuple[Tensor, int]:
    """(x with NaN/Inf zeroed, how many there were). Clean inputs pass
    through as the same tensor."""
    n_bad = nonfinite_count(x)
    if n_bad:
        x = zero_nonfinite(x)
    return x, n_bad


def gram_health(h: Tensor, w2ds: Sequence[Tensor] = ()
                ) -> Tuple[int, int, List[int]]:
    """(nonfinite entries of H, dead diagonal columns of H, nonfinite
    entries per weight) in one host read."""
    diag = torch.diagonal(h, dim1=-2, dim2=-1)
    vals = [torch.sum(~torch.isfinite(h)), torch.sum(diag <= EPS)]
    vals += [torch.sum(~torch.isfinite(w)) for w in w2ds]
    out = torch.stack(vals).tolist()  # comq: allow(host-sync) one read a Gram
    return int(out[0]), int(out[1]), [int(v) for v in out[2:]]


# ---------------------------------------------------------------------------
# escalating diagonal damping
# ---------------------------------------------------------------------------

def damp_hessian(h: Tensor, mult, diag_mean=None) -> Tensor:
    """H + mult · mean(diag H) · I (batched over leading dims); the mean is
    floored at EPS so an all-zero H still moves."""
    m = h.shape[-1]
    if diag_mean is None:
        diag_mean = torch.diagonal(h, dim1=-2, dim2=-1).mean(dim=-1)
    lam = mult * torch.clamp(torch.as_tensor(diag_mean, dtype=torch.float32,
                                             device=h.device), min=EPS)
    return h + torch.eye(m, dtype=h.dtype, device=h.device) * lam[..., None,
                                                                  None]


def damped_inverse(h: Tensor, start: float = 0.01, diag_mean=None,
                   max_tries: int = 4):
    """(H + λI)⁻¹ with λ escalated ×10 per retry until the inverse is
    finite. Returns (hinv, final multiplier); after max_tries a still-bad
    inverse has its non-finite entries zeroed and is left to the caller's
    fallback chain."""
    m = h.shape[-1]
    if diag_mean is None:
        diag_mean = torch.diagonal(h).mean()
    base = torch.clamp(torch.as_tensor(diag_mean, dtype=torch.float32),
                       min=EPS)
    eye = torch.eye(m, dtype=h.dtype, device=h.device)
    mult = start
    hinv = torch.linalg.inv(h + eye * (mult * base))
    for _ in range(max_tries):
        if bool(torch.isfinite(hinv).all()):
            break
        mult *= 10.0
        hinv = torch.linalg.inv(h + eye * (mult * base))
    return zero_nonfinite(hinv), mult


# ---------------------------------------------------------------------------
# guarded solve: damping escalation + fallback chain
# ---------------------------------------------------------------------------

def solver_chain(method: str) -> Tuple[Tuple[str, Optional[str]], ...]:
    """(method, schedule) stages to try in order."""
    if method == "comq_blocked":
        return (("comq_blocked", "trailing"), ("comq_blocked", "refresh"),
                ("rtn", None))
    if method in ("comq", "gptq"):
        return ((method, None), ("rtn", None))
    return (("rtn", None),)


def result_ok(r, ref_err=None) -> bool:
    """Scales and errors finite and — given `ref_err`, the data-free RTN
    error on the same grid — the final H-space error at most
    EXPLODE_FACTOR × it. One scalar read."""
    delta = torch.as_tensor(r.delta, dtype=torch.float32)
    errs = torch.as_tensor(r.errors, dtype=torch.float32)
    ok = torch.isfinite(delta).all() & torch.isfinite(errs).all()
    if ref_err is not None:
        base = torch.clamp(torch.as_tensor(ref_err, dtype=torch.float32),
                           min=1e-6)
        ok = ok & (errs[-1] <= EXPLODE_FACTOR * base)
    return bool(ok)


def guarded_solve(h: Tensor, w2d: Tensor, spec: QuantSpec, method: str, *,
                  block: int = 256, gctx: Optional[GuardContext] = None,
                  layer: int = -1, names: Sequence[str] = ("?",),
                  solve_fn=None, presanitized: bool = False, ref_err=None):
    """`pipeline.solve` under the full guard policy: sanitize the inputs,
    try the method undamped (the unguarded solve when healthy), then
    escalate damping through DAMP_MULTS, then walk solver_chain, and last
    quantize data-free RTN. Records one GuardEvent per protected leaf for
    everything it had to do. `ref_err`, the RTN error on the same grid
    and (sanitized) H, is computed here unless the caller has it."""
    if solve_fn is None:
        from repro_torch.core.pipeline import solve as solve_fn
    if gctx is None or not gctx.enabled:
        return solve_fn(h, w2d, spec, method, block=block)

    if not presanitized:
        h, n_bad = sanitize_array(h)
        if n_bad:
            for nm in names:
                gctx.record(layer, nm, "nonfinite_gram", count=n_bad)
        w2d, n_badw = sanitize_array(w2d)
        if n_badw:
            for nm in names:
                gctx.record(layer, nm, "nonfinite_weight", count=n_badw)
        # comq: allow(host-sync) sentinel: one scalar per guarded solve
        n_dead = int(torch.sum(torch.diagonal(h) <= EPS))
        if n_dead:
            for nm in names:
                gctx.record(layer, nm, "dead_columns", warn=False,
                            count=n_dead)

    from repro_torch.core.baselines import rtn_quantize
    if ref_err is None:
        ref_err = rtn_quantize(w2d, spec, h=h).errors[-1]
    diag_mean = torch.diagonal(h).mean()
    for stage, (meth, schedule) in enumerate(solver_chain(method)):
        tag = meth if schedule in (None, "trailing") else f"{meth}:{schedule}"
        for mult in (0.0,) + DAMP_MULTS:
            hd = h if mult == 0.0 else damp_hessian(h, mult, diag_mean)
            r = solve_fn(hd, w2d, spec, meth, block=block, schedule=schedule)
            if result_ok(r, ref_err):
                if mult:
                    for nm in names:
                        gctx.record(layer, nm, "damping_escalated",
                                    mult=mult, solver=tag)
                if stage:
                    for nm in names:
                        gctx.record(layer, nm, "fallback", solver=tag)
                return r
    r = rtn_quantize(w2d, spec)     # data-free: finite by construction
    for nm in names:
        gctx.record(layer, nm, "fallback", solver="rtn_no_h")
    return r
