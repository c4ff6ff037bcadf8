"""Up-front calibration validation and the trainer's sharded loader (port
of `repro.data.loader`).

* `validate_calib_tokens` / `validate_calib_features` /
  `check_calib_coverage`: the quantization pipeline's checks of tokens, a
  VLM's image features and coverage.
* `ShardedLoader`: each host materializes only its slice of the global
  batch (from host_id / host_count; one host here, but the slicing is the
  multi-host one) and a daemon thread keeps a small prefetch queue ahead
  of the training loop. The stream position (`state()`) is part of the
  checkpoint, so restarts are sample-exact. Batches are numpy, equal to
  the JAX package's bit for bit.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import CalibrationDataError, SyntheticLM


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


class ShardedLoader:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int, *,
                 seed: int = 0, host_id: int = 0, host_count: int = 1,
                 prefetch: int = 2, start_step: int = 0):
        assert global_batch % host_count == 0
        self.local_batch = global_batch // host_count
        self.host_id = host_id
        self.seq_len = seq_len
        self.gen = SyntheticLM(vocab_size, seed)
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _produce(self, step: int) -> Dict[str, np.ndarray]:
        # host slice: a deterministic function of (step, host_id)
        return self.gen.sample(self.local_batch, self.seq_len, step)

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._produce(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def close(self):
        """Stop the prefetch thread and drain its queue."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
