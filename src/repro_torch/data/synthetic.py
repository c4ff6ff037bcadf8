"""Deterministic synthetic token streams and calibration data errors (port
of `repro.data.synthetic`; numpy only, so the streams equal the JAX
package's bit for bit).

A seeded Markov-ish mixture over the vocab: each document samples a topic
that biases token transitions, so the stream has learnable structure
(losses drop below uniform entropy): the trainer's task signal.
`hash((step, batch, seq_len))` of a tuple of ints does not depend on
PYTHONHASHSEED.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

Array = np.ndarray


class CalibrationDataError(ValueError):
    """A calibration batch failed up-front validation (empty, wrong
    rank/dtype, out-of-range ids) — raised with a clear message instead of
    a shape blowup deep inside the Gram accumulation."""


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0, n_topics: int = 16,
                 order_bias: float = 0.8):
        self.vocab = vocab_size
        self.rng = np.random.RandomState(seed)
        self.n_topics = n_topics
        self.order_bias = order_bias
        # per-topic preferred successor offsets (small = learnable)
        self.offsets = self.rng.randint(1, 17, size=(n_topics,))

    def sample(self, batch: int, seq_len: int, step: int = 0
               ) -> Dict[str, Array]:
        """{"tokens", "labels"}: (batch, seq_len) int32 each, labels the
        tokens shifted by one; a pure function of (seed, step, batch,
        seq_len)."""
        if batch <= 0 or seq_len <= 0:
            raise CalibrationDataError(
                f"sample(batch={batch}, seq_len={seq_len}): both must be "
                "positive")
        rng = np.random.RandomState((hash((step, batch, seq_len))
                                     & 0x7FFFFFFF))
        topics = rng.randint(0, self.n_topics, size=(batch,))
        # two levels of structure: a restricted active vocabulary (unigram
        # skew, learned within tens of steps) and topic-dependent successor
        # offsets (bigram structure, learned more slowly)
        active = max(4, self.vocab // 8)
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, active, size=(batch,))
        offs = self.offsets[topics]
        for t in range(1, seq_len + 1):
            follow = (toks[:, t - 1] + offs) % active
            rand = rng.randint(0, active, size=(batch,))
            use_follow = rng.rand(batch) < self.order_bias
            toks[:, t] = np.where(use_follow, follow, rand)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(vocab_size: int, batch: int, seq_len: int, *, seed: int = 0,
            start_step: int = 0) -> Iterator[Dict[str, Array]]:
    """Infinite deterministic batch stream; resumable via start_step."""
    gen = SyntheticLM(vocab_size, seed)
    step = start_step
    while True:
        yield gen.sample(batch, seq_len, step)
        step += 1
