"""Continuous-batching scheduler: priority admission, page accounting,
preemption-by-page-reclaim (the port's own copy of
`repro.serve.scheduler`).

Host-side policy only — no device arrays. The runtime asks the scheduler
which queued requests can start *now* and, each decode step, for the pages
the step is about to write. Two admission policies:

* ``policy="preempt"`` (default) — **incremental allocation**: admission
  needs a decode slot plus only the pages the prefill will write; decode
  growth allocates one page at a time (`ensure_pages`). On pool exhaustion
  the scheduler reclaims pages by preempting the *victim* — the running
  request with the numerically largest ``(priority, rid)``, i.e. the least
  important, latest-arrived one — freeing its pages and re-queueing it for
  recompute-based resume (the runtime re-prefills prompt + already-emitted
  tokens; bit-determinism makes the resumed stream token-identical, which
  is what the fault tests assert). A preempted request keeps its rid, so
  within its priority class it re-admits ahead of anything newer —
  starvation-free. Reservation no longer caps occupancy: pages track live
  tokens.
* ``policy="reserve"`` — the PR-4 behavior kept for A/B
  for A/B: every page the request can ever touch is reserved at admission, so an admitted request runs to
  completion with no preemption; exhaustion backpressures the queue.

Admission is ordered by ``(priority, rid)`` — priority class first (lower
= more urgent), arrival order within a class; `priority=0` everywhere
degrades to the old strict FCFS. The head of the order blocks later
requests (no head-of-line bypass), and under ``preempt`` a head that is
*strictly* more urgent than a running victim may reclaim that victim's
slot/pages at admission too.

Prompts are right-padded to a small static set of bucket lengths, so
prefill runs at a few fixed shapes (causal attention makes the prefix K/V
and the last-prompt-token logits exact; pad rows are never copied into
the paged pool). Resumed requests re-prefill prompt + emitted tokens,
which can exceed the configured buckets — those extend to the next power
of two.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.kv_cache import BlockAllocator, blocks_for

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512)


@dataclasses.dataclass(eq=False)     # identity equality: queue bookkeeping
class Request:
    """A generation request and its full lifecycle record.

    `priority` is the admission class: lower is more urgent; ties admit in
    arrival order. `seed` makes sampling replayable — every sampled token
    is a pure function of (seed, token index), independent of batch
    composition, decode-step count or slot, so a preempted/resumed or
    crash-replayed request redraws the identical stream. `stop_tokens`
    terminates generation early (the stop token itself is emitted and the
    request retires on the same step). `finish_reason` records which bound
    fired. Exceptions raised by `stream_cb` are contained (recorded in
    `cb_errors`) — a broken consumer must not poison the shared decode
    batch."""
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    stop_tokens: Tuple[int, ...] = ()
    stream_cb: Optional[Callable[["Request", int], None]] = None
    priority: int = 0
    seed: Optional[int] = None
    # filled by scheduler/runtime
    rid: int = -1
    state: str = "queued"               # queued | running | done
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    itl: List[float] = dataclasses.field(default_factory=list)
    finish_reason: str = ""             # "stop_token" | "length"
    n_preempts: int = 0
    cb_errors: List[BaseException] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_submit

    def emit(self, token: int, now: float) -> None:
        if self.out_tokens:
            self.itl.append(now - self._t_last)
        else:
            self.t_first_token = now
        self._t_last = now
        self.out_tokens.append(int(token))
        if self.stream_cb is not None:
            try:
                self.stream_cb(self, int(token))
            except Exception as e:   # noqa: BLE001 — contain consumer bugs
                self.cb_errors.append(e)

    def finished(self) -> bool:
        """Stop-token or length bound reached; sets finish_reason."""
        if self.out_tokens and self.out_tokens[-1] in self.stop_tokens:
            self.finish_reason = "stop_token"
            return True
        if len(self.out_tokens) >= self.max_new_tokens:
            self.finish_reason = "length"
            return True
        return False


def _order_key(req: Request) -> Tuple[int, int]:
    return (req.priority, req.rid)


class Scheduler:
    """Priority queue + slot table + page accounting over a BlockAllocator."""

    def __init__(self, max_slots: int, allocator: BlockAllocator,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 block_size: int = 16,
                 max_blocks_per_slot: Optional[int] = None,
                 policy: str = "preempt"):
        if policy not in ("preempt", "reserve"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.max_slots = max_slots
        self.allocator = allocator
        self.buckets = tuple(sorted(buckets))
        self.block_size = block_size
        self.policy = policy
        self.max_blocks_per_slot = (
            max_blocks_per_slot
            if max_blocks_per_slot is not None
            else blocks_for(self.buckets[-1] + 64, block_size))
        self.queue: List[Request] = []
        self.running: Dict[int, Request] = {}     # slot -> request
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._rid = itertools.count()
        self.completed: List[Request] = []
        self.preemptions = 0
        # a partitioned allocator splits the pool into contiguous page
        # ranges, and slots pin to the partition holding their slice of
        # the batch dim, so a slot only references its partition's pages
        if max_slots % allocator.partitions:
            raise ValueError(
                f"max_slots={max_slots} must split evenly over "
                f"{allocator.partitions} pool partitions")
        self._slots_per_part = max_slots // allocator.partitions

    def partition_of_slot(self, slot: int) -> int:
        return slot // self._slots_per_part

    # -- intake --------------------------------------------------------------

    def bucket_for(self, prompt_len: int, extend: bool = False) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        if extend:
            # resumed requests re-prefill prompt + emitted tokens, which is
            # bounded by prompt + max_new — power-of-two extents keep the
            # set of prefill shapes small
            return 1 << max(prompt_len - 1, 1).bit_length()
        raise ValueError(f"prompt length {prompt_len} exceeds the largest "
                         f"prefill bucket {self.buckets[-1]}")

    def lifetime_blocks(self, req: Request) -> int:
        """Pages the request can ever touch (prompt rows + max_new-1
        decoded K/V rows; the final sampled token is never fed back).
        Reserved up front under ``reserve``; under ``preempt`` it is only
        the submit-time feasibility bound (a solo request must fit the
        pool, or no amount of preemption could finish it)."""
        n = blocks_for(req.prompt_len + max(req.max_new_tokens - 1, 0),
                       self.block_size)
        if n > self.max_blocks_per_slot:
            raise ValueError(
                f"request needs {n} pages > max_blocks_per_slot="
                f"{self.max_blocks_per_slot} (prompt {req.prompt_len} + "
                f"max_new {req.max_new_tokens})")
        return n

    def initial_blocks(self, req: Request) -> int:
        """Pages needed at (re-)admission: full lifetime under ``reserve``;
        just the prefill rows under ``preempt`` (fresh: the prompt; resume:
        prompt + all emitted tokens but the last, which the decode step
        feeds back and writes via `ensure_pages`)."""
        if self.policy == "reserve":
            return self.lifetime_blocks(req)
        rows = req.prompt_len + max(len(req.out_tokens) - 1, 0)
        return blocks_for(rows, self.block_size)

    def submit(self, req: Request) -> Request:
        req.rid = next(self._rid)
        req.t_submit = time.time()
        self.bucket_for(req.prompt_len)       # validate early
        need = self.lifetime_blocks(req)
        if need > self.allocator.partition_blocks:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.allocator.partition_blocks} per partition — it "
                "could never be admitted")
        self.queue.append(req)
        return req

    def resubmit(self, req: Request, rid: int) -> Request:
        """Crash-replay intake: re-queue a journaled in-flight request
        under its *original* rid (admission precedence and journal
        identity are keyed on it). The rid counter must already be
        advanced past every journaled rid (`advance_rids`)."""
        req.rid = rid
        req.t_submit = time.time()
        self.bucket_for(req.prompt_len)
        if self.lifetime_blocks(req) > self.allocator.partition_blocks:
            raise ValueError("replayed request no longer fits the pool")
        self.queue.append(req)
        return req

    def advance_rids(self, past: int) -> None:
        self._rid = itertools.count(past + 1)

    # -- admission -----------------------------------------------------------

    def _head(self) -> Optional[Request]:
        return min(self.queue, key=_order_key) if self.queue else None

    def _pick_victim(self, part: Optional[int] = None) -> Optional[Request]:
        """The least-important running request: largest (priority, rid).
        With `part` set, only requests whose slot lives in that pool
        partition qualify — reclaiming pages a different device shard
        owns could never satisfy this allocation."""
        pool = [r for r in self.running.values()
                if part is None or self.partition_of_slot(r.slot) == part]
        return max(pool, key=_order_key) if pool else None

    def _slot_index_for(self, need: int) -> int:
        """Index into `_free_slots` of the slot to admit into: the pop-
        order (last) slot unless another free slot's partition can already
        satisfy the page allocation. Single-partition pools always take
        the last slot — identical to the pre-partition behavior."""
        for i in range(len(self._free_slots) - 1, -1, -1):
            part = self.partition_of_slot(self._free_slots[i])
            if self.allocator.num_free_in(part) >= need:
                return i
        return len(self._free_slots) - 1

    def preempt(self, req: Request,
                on_preempt: Optional[Callable[[Request], None]] = None
                ) -> None:
        """Reclaim a running request's slot and pages; re-queue it for
        recompute-based resume. `on_preempt(req)` runs while `req.slot` is
        still set, so the runtime can clear its device-side slot state."""
        assert self.policy == "preempt", "no preemption under reserve"
        assert self.running.get(req.slot) is req, "preempt of non-running"
        del self.running[req.slot]
        self.allocator.free(req.blocks)
        req.blocks = []
        if on_preempt is not None:
            on_preempt(req)
        self._free_slots.append(req.slot)
        req.slot = -1
        req.state = "queued"
        req.n_preempts += 1
        self.preemptions += 1
        self.queue.append(req)

    def admit(self, on_preempt: Optional[Callable[[Request], None]] = None
              ) -> List[Request]:
        """Admit queued requests in (priority, rid) order while a slot +
        pages are available. The head of the order blocks later requests —
        no bypass, so arrival order is preserved within a priority class.
        Under ``preempt``, a head that is strictly more urgent than the
        current victim candidate reclaims that victim's slot/pages."""
        admitted = []
        while self.queue:
            req = self._head()
            need = self.initial_blocks(req)
            while True:
                if self._free_slots:
                    idx = self._slot_index_for(need)
                    part = self.partition_of_slot(self._free_slots[idx])
                    if self.allocator.num_free_in(part) >= need:
                        break
                else:
                    part = None      # need a slot first: any victim works
                victim = self._pick_victim(part)
                if (self.policy != "preempt" or victim is None
                        or _order_key(victim) <= _order_key(req)):
                    break
                self.preempt(victim, on_preempt)
            if not self._free_slots:
                break
            idx = self._slot_index_for(need)
            part = self.partition_of_slot(self._free_slots[idx])
            blocks = self.allocator.alloc(need, part)
            if blocks is None:       # pool exhausted: backpressure
                break
            self.queue.remove(req)
            req.blocks = blocks
            req.slot = self._free_slots.pop(idx)
            req.state = "running"
            self.running[req.slot] = req
            admitted.append(req)
        return admitted

    # -- decode-time page growth ---------------------------------------------

    def ensure_pages(self, req: Request, total_blocks: int,
                     on_preempt: Optional[Callable[[Request], None]] = None
                     ) -> bool:
        """Grow `req.blocks` to `total_blocks` pages before a decode step
        writes into them. Under ``reserve`` the pages were all allocated at
        admission. Under ``preempt``, exhaustion preempts victims until the
        allocation fits; if `req` itself is the victim (it is the least
        important running request) it is preempted and False is returned —
        the caller must drop it from the step."""
        if total_blocks > self.max_blocks_per_slot:
            raise ValueError(f"request {req.rid} grew past "
                             f"max_blocks_per_slot={self.max_blocks_per_slot}")
        part = self.partition_of_slot(req.slot)
        while len(req.blocks) < total_blocks:
            got = self.allocator.alloc(total_blocks - len(req.blocks), part)
            if got is not None:
                req.blocks.extend(got)
                return True
            if self.policy != "preempt":
                raise RuntimeError(
                    f"page pool exhausted growing request {req.rid} under "
                    "reserve policy — lifetime reservation should have "
                    "covered this (allocator accounting bug)")
            victim = self._pick_victim(part)
            if victim is None or victim is req:
                # req is the least-important running request (or an
                # injected alloc fault fired with nothing to reclaim):
                # preempt req itself; it re-queues and resumes later.
                if self.running.get(req.slot) is req:
                    self.preempt(req, on_preempt)
                return False
            self.preempt(victim, on_preempt)
        return True

    def release(self, req: Request) -> None:
        """Return a finished request's slot and pages to the pool."""
        assert self.running.get(req.slot) is req, "release of non-running"
        del self.running[req.slot]
        self.allocator.free(req.blocks)
        req.blocks = []
        self._free_slots.append(req.slot)
        req.slot = -1
        req.state = "done"
        req.t_done = time.time()
        self.completed.append(req)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running
