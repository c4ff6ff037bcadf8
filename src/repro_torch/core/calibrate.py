"""Calibration: the Gram matrix H = XᵀX of an activation tap (port of
`repro.core.calibrate`, single device)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class GramAccumulator:
    """Streaming H = Σ XᵀX over calibration batches (f32), held on the
    card unless `device="cpu"`."""

    def __init__(self, dim: int, device: DeviceLike = None):
        self.h = torch.zeros(dim, dim, dtype=torch.float32,
                             device=resolve_device(device))
        self.count = 0

    def update(self, x: Tensor) -> "GramAccumulator":
        x2 = x.reshape(-1, x.shape[-1]).float()
        self.h = self.h + x2.T @ x2
        self.count += x2.shape[0]
        return self

    def value(self) -> Tensor:
        return self.h


def gram_from_tap(tap: Tensor) -> Tensor:
    """(B, T, d) activation tap -> (d, d) f32 Gram matrix."""
    x2 = tap.reshape(-1, tap.shape[-1]).float()
    return x2.T @ x2


def batched_gram(tap: Tensor) -> Tensor:
    """(E, C, d) stacked-expert tap -> (E, d, d): one Gram per expert in
    one batched product. Empty capacity slots are zero rows and add
    nothing."""
    t = tap.float()
    return torch.bmm(t.transpose(1, 2), t)


class TapGramCache:
    """One Gram per activation tap: leaves sharing a tap (wq/wk/wv on
    attn_in, w_gate/w_up on mlp_in or expert_in) reuse one H — 4 Gram
    matmuls per dense layer instead of 7. Scope one instance per layer."""

    def __init__(self):
        self._grams: Dict[str, Tensor] = {}
        self.computed = 0      # number of Gram matmuls issued

    def gram(self, name: str, tap: Tensor) -> Tensor:
        if name not in self._grams:
            self._grams[name] = gram_from_tap(tap)
            self.computed += 1
        return self._grams[name]

    def batched(self, name: str, tap: Tensor) -> Tensor:
        """The per-expert Grams (E, d, d) of a stacked-expert tap."""
        if name not in self._grams:
            self._grams[name] = batched_gram(tap)
            self.computed += 1
        return self._grams[name]
