"""`comq_panel`: the intra-panel COMQ coordinate sweep of the blocked
solver — Hopper kernel (csrc/comq_panel.cu) and its plain version.

Replaces the Pallas TPU kernel `src/repro/kernels/comq_panel.py`
(`_panel_call`, entry `comq_panel_dq_pallas`). The source notes what
bounds it on the H100 and how the design answers that; in short, a
blocked sweep: the B rows are cut into sub-panels of 16, one thread a
column walks a sub-panel's chain, then all warps of the block apply the
rank-16 update to the rows after it; a block owns 4-32 columns, fewer
when n is small, so that the card fills. A stack of E experts (operands
with a leading E axis) is one launch: the experts are a grid dimension
and each block runs the single-panel code on its expert's operands, so an
expert's result is the one a single launch on its slices gives, bit for
bit.

Tolerance against the plain version: the kernel sums s_t in another order,
so a code can flip where s_t lands on a rounding boundary; on random panels
at the main path's shapes ≥ 99.9% of codes must be identical (checked on
the card by chip_smoke.py and tests/test_torch_kernels.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.comq_hessian import panel_sweep_dq_ref
from repro_torch.kernels import build

Tensor = torch.Tensor
NAME = "comq_panel"
launches = 0     # kernel launches since the last reset (chip_smoke reads it)
launches_batched = 0   # the share of them over more than one expert



def comq_panel_dq_plain(h_bb: Tensor, s0: Tensor, qf: Tensor, delta, z_lo,
                        z_hi, hdiag: Tensor):
    """The plain version: `panel_sweep_dq_ref`, once per expert when the
    operands carry a leading expert axis (h_bb (E, B, B), s0 / qf
    (E, B, n), delta / z_lo / z_hi (E, n), hdiag (E, B))."""
    if h_bb.dim() == 2:
        return panel_sweep_dq_ref(h_bb, s0, qf, delta, z_lo, z_hi, hdiag)
    outs = [panel_sweep_dq_ref(h_bb[e], s0[e], qf[e], delta[e], z_lo[e],
                               z_hi[e], hdiag[e])
            for e in range(h_bb.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _vec(a, shape, dev) -> Tensor:
    """Scalar, (n,) or (E, n) grid parameter -> contiguous `shape` f32 on
    `dev`."""
    t = torch.as_tensor(a, device=dev).to(torch.float32)
    return t.expand(shape).contiguous() if t.dim() == 0 else t.contiguous()


@functools.lru_cache(maxsize=None)
def max_b() -> int:
    """The largest panel B the kernel takes: its rows' running s and h_bb
    strips must fit one block's shared memory (889 on the H100)."""
    return build.load(NAME, "comq_panel_max_b", [])()


def comq_panel_dq_cuda(h_bb: Tensor, s0: Tensor, qf: Tensor, delta, z_lo,
                       z_hi, hdiag: Tensor):
    """Launch the kernel: returns (qf', ΔW), each (B, n) f32, or (E, B, n)
    for a stack of experts (h_bb (E, B, B), s0 / qf (E, B, n), delta /
    z_lo / z_hi (E, n), hdiag (E, B)), all in one launch. B may be at most
    `max_b()`."""
    global launches, launches_batched
    dev = qf.device
    if dev.type != "cuda":
        raise RuntimeError(f"comq_panel kernel needs CUDA tensors, got {dev}")
    lead = tuple(qf.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"comq_panel: qf must be (B, n) or (E, B, n), got "
                         f"{tuple(qf.shape)}")
    E = lead[0] if lead else 1
    B, n = qf.shape[-2:]
    delta, z_lo, z_hi = (_vec(a, lead + (n,), dev)
                         for a in (delta, z_lo, z_hi))
    for name, t, shape in (("h_bb", h_bb, (B, B)), ("s0", s0, (B, n)),
                           ("qf", qf, (B, n)), ("hdiag", hdiag, (B,)),
                           ("delta", delta, (n,)), ("z_lo", z_lo, (n,)),
                           ("z_hi", z_hi, (n,))):
        shape = lead + shape
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"comq_panel: {name} must be f32 on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"comq_panel: {name} must be contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    if B > max_b():
        raise ValueError(f"comq_panel: a panel of B={B} rows does not fit a "
                         f"block's shared memory; the kernel takes B up to "
                         f"{max_b()}")
    qf_out = torch.empty_like(qf)
    dq = torch.empty_like(qf)
    fn = build.load(NAME, "comq_panel_dq", _ARGTYPES)
    rc = fn(h_bb.data_ptr(), s0.data_ptr(), qf.data_ptr(), delta.data_ptr(),
            z_lo.data_ptr(), z_hi.data_ptr(), hdiag.data_ptr(),
            qf_out.data_ptr(), dq.data_ptr(), E, B, n,
            build.sm_count(dev.index),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(NAME, rc)
    launches += 1
    launches_batched += E > 1
    return qf_out, dq
