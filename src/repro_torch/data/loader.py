"""Up-front calibration validation (port of the part of
`repro.data.loader` the quantization pipeline uses: tokens, a VLM's image
features, coverage)."""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import CalibrationDataError


def validate_calib_tokens(tokens, vocab_size: Optional[int] = None):
    """Check a (B, T) calibration token batch — non-empty, rank 2, integer
    dtype, ids inside the vocab — raising CalibrationDataError with a clear
    message. Returns `tokens` unchanged."""
    if tokens is None:
        raise CalibrationDataError("calibration tokens are None")
    arr = (tokens.detach().cpu().numpy() if isinstance(tokens, torch.Tensor)
           else np.asarray(tokens))
    if arr.size == 0:
        raise CalibrationDataError(
            f"calibration token batch is empty (shape {arr.shape})")
    if arr.ndim != 2:
        raise CalibrationDataError(
            f"calibration tokens must be rank 2 (batch, seq), got shape "
            f"{tuple(arr.shape)}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise CalibrationDataError(
            f"calibration tokens must be integer ids, got dtype {arr.dtype}")
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or (vocab_size is not None and hi >= vocab_size):
        raise CalibrationDataError(
            f"calibration token ids out of range [{lo}, {hi}] for vocab "
            f"size {vocab_size}")
    return tokens


def validate_calib_features(x, name: str = "vision_embeds"):
    """Check a floating calibration feature batch (a VLM's image
    embeddings): non-empty, floating, all-finite, raising
    CalibrationDataError. Non-finite *input* features are a data bug;
    non-finite values that appear inside the activation stream are the
    numeric guards' job (core/guards.py). Returns `x` unchanged."""
    if x is None:
        raise CalibrationDataError(f"{name} is None")
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.numel() == 0:
        raise CalibrationDataError(
            f"{name} is empty (shape {tuple(t.shape)})")
    if not t.is_floating_point():
        raise CalibrationDataError(
            f"{name} must be floating, got dtype {t.dtype}")
    n_bad = int((~torch.isfinite(t)).sum())
    if n_bad:
        raise CalibrationDataError(
            f"{name} contains {n_bad} non-finite entries")
    return x


def check_calib_coverage(n_tokens: int, leaf_dims: Dict[str, int]) -> bool:
    """Warn when the calibration token count is below the input dimension
    of any leaf class (the Gram is then rank-deficient). Returns True when
    coverage is sufficient."""
    short = {k: d for k, d in leaf_dims.items() if n_tokens < d}
    if short:
        worst = max(short.values())
        warnings.warn(
            f"calibration has {n_tokens} tokens but leaf input dims up "
            f"to {worst} ({', '.join(f'{k}={d}' for k, d in sorted(short.items()))}): "
            "the Gram is rank-deficient (use a larger calibration batch)",
            stacklevel=3)
    return not short
