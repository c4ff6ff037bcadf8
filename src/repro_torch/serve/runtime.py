"""Continuous-batching serving runtime over the paged KV cache (port of
`repro.serve.runtime`).

The runtime ties together:

* `serve/scheduler.py` — priority admission, prefill buckets, incremental
  page allocation + preemption-by-page-reclaim (or full-lifetime
  reservation under ``policy="reserve"``);
* `serve/kv_cache.py` — the paged pool + block tables + host allocator;
* `models/model.py::decode_step_paged` — one decode step with per-slot
  positions, so slots at different sequence lengths (mixed lengths,
  staggered arrivals) share every decode step; its attention runs the
  `paged_attention[_quant]` kernels on the card;
* `serve/sampler.py::sample_batch_seeded` — per-slot sampling settings,
  with every draw a pure function of (request seed, token index);
* `ft/journal.py` — optional crash-replay request journal: submits, first
  tokens and retirements are fsync-gated, and `recover_runtime` rebuilds
  the queue after a process death, replaying in-flight requests token for
  token (deterministic decode + seeded sampling);
* `ft/inject.py` — optional deterministic fault injection (page-alloc
  failure, decode-step exception, callback error, simulated kill);
* `obs/` — optional tracer and metrics registry: the JAX runtime's
  request lifecycle events (submit, admit, first_token, token, preempt,
  retire), a `decode_step` span per step (a `torch.profiler` user
  annotation around the step's kernels), the `serve.run` span, and its
  counters, histograms and pool gauges.

The batch shape is fixed at `max_slots` rows and every kernel computes a
row from that row's inputs alone, so a request's tokens do not depend on
its batchmates: mixed traffic reproduces solo runs token for token. An
MoE layer routes every slot, the inactive ones too, and at up to 8 slots
no expert gets more pairs than the capacity floor of 8, so no decode
token is dropped and the same holds. Prefill runs one request at a time
with its padding after the prompt, so padding never takes a real token's
capacity slot.

Preemption is recompute-based: the victim's pages are freed and it
re-queues; on re-admission the runtime re-prefills prompt + all emitted
tokens but the last, then feeds the last emitted token through the normal
decode step, so every resumed token comes from the same decode step as an
uninterrupted run.

The runtime runs JAX's compiled programs as CUDA graphs
(`analysis.retrace.guard_graph`), each captured at its first call and
replayed after; on the CPU each runs eagerly through the same static
buffers. All of one runtime's graphs share one memory pool
(`retrace.GraphPool`), under its rule: they replay one at a time on one
stream, and what reads a graph's outputs is enqueued before the next
graph replays (the write reads the prefill's rows, the first token's
argmax its logits row, the sampling the step's logits).

* ``serve.decode_step`` — JAX's one compiled, donated decode program,
  budget one signature (a fixed (max_slots, maxb) table), replayed every
  step. The graph writes the K/V pool in place, so the pool and the
  params stay the tensors it was captured on (the prefill writes land in
  the same storages). Per step the host writes the tokens and positions
  into pinned buffers that the replay's static inputs are copied from,
  re-copies the block tables into their device buffer only when they
  changed, and pulls the sampled tokens: that pull is the step's one
  host sync, and what makes rewriting the pinned buffers next step safe.
  Sampling runs after the replay, outside the graph.
* ``serve.prefill[bucket]`` — one graph a bucket: the forward of one
  right-padded request, returning the logits row at tlen - 1 (gathered
  inside the graph: the only row read) and the prefill cache's rows and
  positions.
* ``serve.prefill_write[cache_len]`` — one graph a prefill cache length
  (JAX's key): the rows at positions < tlen scattered into the slot's
  pages, the pool written in place (JAX's donation).

A prefill's tokens, true length and table row are uploaded through a
fresh pinned block each (`_upload`): the host never rewrites a buffer a
copy may still read, so admissions need no sync of their own (a resumed
request reads nothing back; a fresh one reads its first token). The
observability hooks read host values only and add none.

Slot+page sharding (`mesh`, a DeviceMesh with a "model" axis of tp over
the SPMD ranks), as in the JAX runtime: the partitioned allocator gives
slot s pages of s's partition only, and each rank holds its own
num_blocks/tp pages. Every rank runs the same scheduler on the same
submissions and every admitted prefill (replicated work, as in JAX);
only the owner of the slot's pages writes its rows. The decode step runs
over the rank's max_slots/tp rows, against its own pages with block-table
ids made local, through the same paged kernels, with no collective
inside; one gather of the sampled tokens over "model" follows it (JAX's
host read of its sharded logits), so every rank's host state advances
alike. Rank 0 alone journals and traces.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.retrace import GraphPool, guard_graph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.inject import InjectedFault, SimulatedKill
from repro_torch.ft.journal import Journal
from repro_torch.models.model import decode_step_paged, forward
from repro_torch.models.transformer import check_paged
from repro_torch.obs.metrics import NULL_METRICS, Histogram
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.kv_cache import (BlockAllocator, blocks_for,
                                        init_paged_cache, paged_cache_bytes,
                                        write_prefill)
from repro_torch.serve.sampler import sample_batch_seeded
from repro_torch.serve.scheduler import DEFAULT_BUCKETS, Request, Scheduler

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 4
    block_size: int = 16
    num_blocks: int = 64
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_blocks_per_slot: Optional[int] = None
    rng_seed: int = 0
    policy: str = "preempt"          # "preempt" | "reserve"


def params_device(params) -> torch.device:
    """Device of the first tensor in a params tree (QT leaves included)."""
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, Tensor):
            return node.device
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "codes"):
            return node.codes.device
    raise ValueError("params hold no tensor")


def check_params_device(params, dev: torch.device) -> None:
    got = params_device(params)
    if got.type != dev.type:
        raise ValueError(f"params are on {got} but the runtime runs on {dev}; "
                         "move them, or pass the matching device")


class Runtime:
    """Continuous-batching runtime: submit() requests, run() to drain.

    Runs on the card unless `device="cpu"`. `journal` (ft.Journal) records
    each request's lifecycle for `recover_runtime`; `injector`
    (ft.FaultInjector) arms the page_alloc, decode_step, callback and kill
    fault points; `tracer` (obs.Tracer) and `metrics`
    (obs.MetricsRegistry) record the JAX runtime's events, spans and
    instruments. `mesh` (a DeviceMesh with a "model" axis; every rank
    constructs the runtime alike and submits the same requests) shards
    slots and pages over the ranks (module docstring); tp must divide
    num_blocks and max_slots."""

    def __init__(self, params, cfg, plan, serve_cfg: ServeConfig = None,
                 journal: Optional[Journal] = None, injector=None,
                 tracer=None, metrics=None, mesh=None,
                 device: DeviceLike = None):
        check_paged(cfg)
        # the paged path quantizes pages, not the static engine's per-entry
        # int8 cache: an int8 cache plan means int8 pages, and the prefill
        # forwards must produce float rows for write_prefill to quantize
        kv_bits = int(getattr(plan, "kv_bits", 0) or 0)
        if plan.cache_quant and kv_bits == 0:
            kv_bits = 8
        if kv_bits not in (0, 4, 8):
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
        if kv_bits:
            plan = plan.replace(cache_quant=False, kv_bits=kv_bits)
        self.kv_bits = kv_bits
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.plan = plan
        sc = serve_cfg or ServeConfig()
        self.serve_cfg = sc
        self.mesh = mesh
        tp, self._rank = 1, 0
        if mesh is not None:
            from repro_torch import dist as _dist
            tp = _dist.tp_size(mesh)
            if not _dist.is_rank0():
                journal, tracer = None, None
        self._tp = tp
        self.journal = journal
        self.injector = injector
        # null singletons when not given; the instrument handles are
        # resolved once here, so a hot call site is a float add or a list
        # append on a host value, never a registry lookup
        self.tracer = tracer or NULL_TRACER
        self.metrics = metrics or NULL_METRICS
        self._m_ttft = self.metrics.histogram("serve.ttft_seconds")
        self._m_itl = self.metrics.histogram("serve.itl_seconds")
        self._m_tokens = self.metrics.counter("serve.tokens_emitted")
        self._m_retired = self.metrics.counter("serve.requests_retired")
        self._m_preempt = self.metrics.counter("serve.preemptions")
        self._m_admits = self.metrics.counter("serve.admits")
        self._m_resumes = self.metrics.counter("serve.resumes")
        self._m_free = self.metrics.gauge("serve.pool_free_blocks")
        self._m_occ = self.metrics.gauge("serve.pool_live_occupancy")
        self._m_pool_bytes = self.metrics.gauge("serve.pool_kv_bytes")
        fail_hook = None
        if injector is not None:
            fail_hook = lambda: injector.fire("page_alloc")  # noqa: E731
        self.allocator = BlockAllocator(sc.num_blocks, fail_hook=fail_hook,
                                        partitions=tp)
        self.scheduler = Scheduler(sc.max_slots, self.allocator,
                                   buckets=sc.buckets,
                                   block_size=sc.block_size,
                                   max_blocks_per_slot=sc.max_blocks_per_slot,
                                   policy=sc.policy)
        self.maxb = self.scheduler.max_blocks_per_slot
        # this rank's pages [page_lo, page_lo + nbl) and slots
        # [slot_lo, slot_lo + spp); the whole pool and batch without a mesh
        self._nbl, self._spp = sc.num_blocks, sc.max_slots
        self._page_lo = self._slot_lo = 0
        if mesh is not None:
            self._rank = _dist.axis_rank(mesh, "model")
            self._group = _dist.axis_group(mesh, "model")
            lay = _dist.paged_layout(tp, sc.max_slots, sc.num_blocks,
                                     self._rank)
            self._nbl, self._spp = lay["blocks"], lay["slots"]
            self._page_lo, self._slot_lo = lay["block_lo"], lay["slot_lo"]
        self.pool = init_paged_cache(cfg, plan, self._nbl, sc.block_size,
                                     device=self.device)
        # bytes of one live page (codes and its share of the scales): the
        # pool-bytes gauge is a host multiply
        self._page_bytes = paged_cache_bytes(
            cfg, plan, sc.num_blocks, sc.block_size) // sc.num_blocks

        B = sc.max_slots
        # host-side decode state, one row per slot
        self._bt = np.zeros((B, self.maxb), np.int32)
        self._pos = np.full((B,), -1, np.int32)
        self._tok = np.zeros((B,), np.int64)
        self._temp = np.zeros((B,), np.float32)
        self._topk = np.zeros((B,), np.int32)
        self._topp = np.zeros((B,), np.float32)
        self._seed = np.zeros((B,), np.uint32)   # per-request sampling seed
        self._count = np.zeros((B,), np.int32)   # tokens emitted so far
        # this rank's rows of the step's inputs in pinned host buffers
        # (rewritten only after the step's token pull has synced), and the
        # block tables' device buffer, re-copied only on change
        self._h_tok = self._host((self._spp, 1), torch.int64)
        self._h_pos = self._host((self._spp,), torch.int32)
        self._h_bt = self._host((self._spp, self.maxb), torch.int32)
        # numpy views of them, which the host writes in place
        self._h_views = tuple(t.numpy() for t in (self._h_tok, self._h_pos,
                                                  self._h_bt))
        self._bt_dev = torch.zeros((self._spp, self.maxb), dtype=torch.int32,
                                   device=self.device)
        self._bt_dirty = True
        self._any_sampling = False   # any live slot with temperature > 0
        # the decode step: one graph, replayed every step (tokens and
        # positions its copied inputs; params, pool and tables held); a
        # graph a prefill bucket and a prefill write's cache length, made
        # at first use; all in one memory pool
        self._graph_pool = GraphPool()
        self._decode = guard_graph(_decode_step, name="serve.decode_step",
                                   max_signatures=1, copy_argnums=(5, 6),
                                   device=self.device, pool=self._graph_pool)
        self._prefills = {}
        self._writes = {}
        # run() metrics
        self.steps = 0
        self.decode_seconds = 0.0
        self._occ_sum = 0.0          # live-token occupancy, summed per step
        self._occ_steps = 0

    def _host(self, shape, dtype) -> Tensor:
        """A zeroed host buffer, pinned when the runtime runs on the card."""
        t = torch.zeros(shape, dtype=dtype)
        return t if self.device.type == "cpu" else t.pin_memory()

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes of the memory pool the runtime's graphs share (0
        on the CPU, or before a capture)."""
        return self._graph_pool.bytes()

    def _upload(self, a: np.ndarray) -> Tensor:
        """Host array -> a tensor on the runtime's device (a copy). On the
        card the copy goes through pinned memory without waiting."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- request intake ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               stop_tokens=(), stream_cb=None, priority: int = 0,
               seed: Optional[int] = None) -> Request:
        req = Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      top_k=top_k, top_p=top_p,
                      stop_tokens=tuple(int(t) for t in stop_tokens),
                      stream_cb=stream_cb, priority=priority, seed=seed)
        self.scheduler.submit(req)
        if req.seed is None:
            # deterministic per-request default
            req.seed = (self.serve_cfg.rng_seed * 1_000_003
                        + req.rid) & 0x7FFFFFFF
        if self.journal is not None:
            self.journal.record_submit(req)
        self.tracer.request_event("submit", req.rid,
                                  prompt_len=int(req.prompt.shape[0]),
                                  max_new_tokens=int(max_new_tokens),
                                  priority=int(priority))
        return req

    # -- serving loop --------------------------------------------------------

    def _emit(self, req: Request, token: int, now: float) -> None:
        """Append one token to `req`'s stream; with an injector the
        callback fault point wraps its stream callback (its error stays on
        `req.cb_errors`)."""
        inj = self.injector
        if inj is not None and req.stream_cb is not None:
            orig = req.stream_cb

            def guarded(r, t):
                if inj.fire("callback"):
                    raise InjectedFault("injected stream-callback failure")
                orig(r, t)

            req.stream_cb = guarded
            try:
                req.emit(token, now)
            finally:
                req.stream_cb = orig
        else:
            req.emit(token, now)
        # the token's index in the stream: a crash replay re-delivers the
        # same prefix, and timelines dedup by (rid, i)
        self.tracer.token_event(req.rid, len(req.out_tokens) - 1, token,
                                now * 1e6)
        self._m_tokens.inc()

    def _clear_slot(self, req: Request) -> None:
        """Scheduler preemption callback: wipe the victim's slot state
        while `req.slot` is still assigned."""
        s = req.slot
        self._pos[s] = -1
        self._bt[s] = 0
        self._tok[s] = 0
        self._temp[s] = 0.0
        self._topk[s] = 0
        self._topp[s] = 0.0
        self._seed[s] = 0
        self._count[s] = 0
        self._bt_dirty = True
        self._any_sampling = bool((self._temp > 0.0).any())
        if self.journal is not None:
            self.journal.record_preempt(req)
        self.tracer.request_event("preempt", req.rid,
                                  n_preempts=int(req.n_preempts) + 1)
        self._m_preempt.inc()

    def _prefill_fn(self, bucket: int):
        """JAX's `serve.prefill[bucket]`: the bucket's graph (one
        signature), called as fn(tokens (1, bucket), tlen) on the device."""
        fn = self._prefills.get(bucket)
        if fn is None:
            # cache capacity >= bucket: the right-pad rows must not
            # ring-evict real rows before the write drops them
            plan = self.plan.replace(prefill_cache_len=bucket)
            graph = guard_graph(_prefill_forward,
                                name=f"serve.prefill[{bucket}]",
                                max_signatures=1, copy_argnums=(3, 4),
                                device=self.device, pool=self._graph_pool)
            fn = self._prefills[bucket] = functools.partial(
                graph, self.params, self.cfg, plan)
        return fn

    def _write_fn(self, cache_len: int):
        """JAX's `serve.prefill_write[cache_len]`: the graph (one
        signature) that writes a prefill cache of `cache_len` rows into
        the pool in place, called as fn(k_seq, v_seq, kv_pos, tlen,
        table_row) on the device."""
        fn = self._writes.get(cache_len)
        if fn is None:
            graph = guard_graph(_write_rows,
                                name=f"serve.prefill_write[{cache_len}]",
                                max_signatures=1,
                                copy_argnums=(2, 3, 4, 5, 6),
                                device=self.device, pool=self._graph_pool)
            fn = self._writes[cache_len] = functools.partial(
                graph, self.pool, self.kv_bits)
        return fn

    def _prefill(self, tokens_in: np.ndarray, bucket: int):
        """Prefill one right-padded request through its bucket's graph;
        returns (the logits row at tlen - 1 (1, V), k_seq, v_seq (L, S,
        KV, hd), positions (S,), tlen as a device scalar)."""
        tlen = len(tokens_in)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :tlen] = tokens_in
        tlen_dev = self._upload(np.asarray(tlen, np.int64))
        return (*self._prefill_fn(bucket)(self._upload(tokens), tlen_dev),
                tlen_dev)

    def _admit_one(self, req: Request) -> int:
        """Prefill + scatter for a newly (re-)admitted request. Fresh
        requests sample their first token from the prefill logits (TTFT)
        and return 1; resumed requests re-prefill prompt + emitted[:-1]
        and feed emitted[-1] through the next decode step, so every
        resumed token comes from the same decode step as an uninterrupted
        run, and 0 new tokens are emitted here."""
        resume = bool(req.out_tokens)
        if resume:
            tokens_in = np.concatenate(
                [req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])
        else:
            tokens_in = req.prompt
        tlen = int(len(tokens_in))
        bucket = self.scheduler.bucket_for(tlen, extend=resume)
        last, k_seq, v_seq, kv_pos, tlen_dev = self._prefill(tokens_in,
                                                             bucket)
        if not resume:
            # the first token (TTFT) from the prefill's logits row: its
            # argmax or draw is enqueued before the write replays, which
            # may reuse the row's memory (the graph pool's rule)
            if req.temperature <= 0.0:
                first = torch.argmax(last, dim=-1)
            else:
                first = sample_batch_seeded(
                    last, [req.seed or 0], [0],
                    temperature=[req.temperature], top_k=[req.top_k],
                    top_p=[req.top_p])
        table_row = np.zeros((self.maxb,), np.int32)
        table_row[:len(req.blocks)] = req.blocks
        s = req.slot
        if self.scheduler.partition_of_slot(s) == self._rank:
            # only positions < true length: the right-pad rows are dropped;
            # under a mesh only the owner of the slot's pages writes them,
            # at their local ids (every other rank drops the rows)
            self._write_fn(int(k_seq.shape[1]))(
                k_seq, v_seq, kv_pos, tlen_dev,
                self._upload(np.maximum(table_row - self._page_lo, 0)))
        self._bt[s] = table_row
        self._pos[s] = tlen          # next decode writes K/V here
        self._temp[s] = req.temperature
        self._topk[s] = req.top_k
        self._topp[s] = req.top_p
        self._seed[s] = np.uint32(req.seed or 0)
        self._bt_dirty = True
        self._any_sampling = bool((self._temp > 0.0).any())
        self.tracer.request_event("admit", req.rid, slot=int(s),
                                  resumed=resume, prefill_len=tlen)
        self._m_admits.inc()
        if resume:
            self._tok[s] = req.out_tokens[-1]
            self._count[s] = len(req.out_tokens)
            if self.journal is not None:
                self.journal.record_resume(req)
            self._m_resumes.inc()
            return 0
        first = int(first[0])        # the TTFT token must reach the stream
        self._emit(req, first, time.time())
        self._tok[s] = first
        self._count[s] = 1
        if self.journal is not None:
            self.journal.record_first_token(req, first)
        self.tracer.request_event("first_token", req.rid, token=first)
        self._m_ttft.observe(req.ttft)
        if req.finished():       # max_new == 1, or the TTFT token is a stop
            self._retire(req)
        return 1

    def _retire(self, req: Request) -> None:
        s = req.slot
        req.finished()               # ensure finish_reason is set
        # the retire record is durable before the pages are reused: a crash
        # can re-stream a request's tokens but never lose or re-run a
        # retired request
        if self.journal is not None:
            self.journal.record_retire(req)
        self.tracer.request_event("retire", req.rid,
                                  reason=req.finish_reason,
                                  new_tokens=len(req.out_tokens))
        self._m_retired.inc()
        for dt in req.itl:           # host floats collected by emit()
            self._m_itl.observe(dt)
        self.scheduler.release(req)
        self._pos[s] = -1
        self._bt[s] = 0
        self._tok[s] = 0
        self._count[s] = 0
        # clear sampling settings too: greedy rows of the seeded sampler
        # equal argmax, so dropping back to it cannot change tokens
        self._temp[s] = 0.0
        self._topk[s] = 0
        self._topp[s] = 0.0
        self._bt_dirty = True
        self._any_sampling = bool((self._temp > 0.0).any())

    def step(self) -> int:
        """Admit what fits (possibly preempting lower-priority victims),
        grow pages for the rows this step writes (possibly preempting),
        then run one decode step for all active slots. Returns the number
        of tokens emitted (prefill first-tokens included)."""
        if self.injector is not None:
            self.injector.check("kill", SimulatedKill)
        emitted = 0
        for req in self.scheduler.admit(on_preempt=self._clear_slot):
            emitted += self._admit_one(req)
        bs = self.serve_cfg.block_size
        for s, req in sorted(self.scheduler.running.items()):
            if req.state != "running":      # preempted earlier this pass
                continue
            needed = int(self._pos[s]) // bs + 1
            self.scheduler.ensure_pages(req, needed,
                                        on_preempt=self._clear_slot)
        running = dict(self.scheduler.running)
        if not running:
            return emitted
        for s, req in running.items():
            row = np.asarray(req.blocks, np.int32)       # grown tables
            if not np.array_equal(self._bt[s, :len(row)], row):
                self._bt[s, :len(row)] = row
                self._bt_dirty = True
        t0 = time.time()
        rows = slice(self._slot_lo, self._slot_lo + self._spp)
        if self.injector is not None:
            self.injector.check("decode_step")
        h_tok, h_pos, h_bt = self._h_views
        if self._bt_dirty:
            # this rank's rows, their page ids made local (the clamp only
            # touches entries past a slot's live pages, which the length
            # mask hides)
            h_bt[:] = np.maximum(self._bt[rows] - self._page_lo, 0)
            self._bt_dev.copy_(self._h_bt, non_blocking=True)
            self._bt_dirty = False
        h_tok[:, 0] = self._tok[rows]
        h_pos[:] = self._pos[rows]
        # the span brackets the step's launches and the token pull it makes
        # anyway: no extra sync, and in a profiler trace the annotation
        # holds the step's kernels
        with self.tracer.span("decode_step", device=True, step=self.steps,
                              slots=len(running)):
            logits = self._decode(self.params, self.cfg, self.plan,
                                  self.pool, self._bt_dev, self._h_tok,
                                  self._h_pos)[0]
            if self._any_sampling:
                toks = sample_batch_seeded(
                    logits, self._seed[rows], self._count[rows],
                    temperature=self._temp[rows], top_k=self._topk[rows],
                    top_p=self._topp[rows])
            else:
                toks = torch.argmax(logits, dim=-1)
            if self._tp > 1:
                toks = self._gather_tokens(toks)
            # comq: allow(host-sync) the step's one host sync: its tokens
            toks = toks.cpu().numpy()
        now = time.time()
        self.steps += 1
        self.decode_seconds += now - t0
        for s, req in running.items():
            self._emit(req, int(toks[s]), now)
            emitted += 1
            self._pos[s] += 1
            self._tok[s] = int(toks[s])
            self._count[s] += 1
            # stop-token or length: slot + pages free on this very step
            if req.finished():
                self._retire(req)
        live = self._live_blocks()
        self._occ_sum += live / self.allocator.num_blocks
        self._occ_steps += 1
        self._m_free.set(self.allocator.num_free)
        self._m_occ.set(live / self.allocator.num_blocks)
        self._m_pool_bytes.set(live * self._page_bytes)
        return emitted

    def _gather_tokens(self, toks: Tensor) -> Tensor:
        """Every rank's sampled tokens, in slot order: one all-gather over
        "model" after the decode step."""
        import torch.distributed as dist
        parts = [torch.empty_like(toks) for _ in range(self._tp)]
        dist.all_gather(parts, toks.contiguous(), group=self._group)
        return torch.cat(parts)

    def _live_blocks(self) -> int:
        """Pages holding written K/V rows."""
        return sum(blocks_for(int(self._pos[s]), self.serve_cfg.block_size)
                   for s in range(self.serve_cfg.max_slots)
                   if self._pos[s] >= 0)

    def run(self) -> dict:
        """Drain the queue; returns aggregate + per-request metrics for
        this call (tokens emitted and requests completed while run() was
        draining). ITL figures come from a Histogram over this run's
        inter-token gaps, whose quantiles equal `np.percentile`'s."""
        t0 = time.time()
        done_before = len(self.scheduler.completed)
        steps_before = self.steps
        occ_sum0, occ_n0 = self._occ_sum, self._occ_steps
        preempt0 = self.scheduler.preemptions
        new_tokens = 0
        with self.tracer.span("serve.run"):
            while not self.scheduler.idle:
                new_tokens += self.step()
        wall = time.time() - t0
        done = self.scheduler.completed[done_before:]
        occ_n = self._occ_steps - occ_n0
        itl = Histogram("serve.itl_seconds")
        for r in done:
            for dt in r.itl:
                itl.observe(dt)
        return {
            "requests": len(done),
            "finish_reasons": [r.finish_reason for r in done],
            "new_tokens": new_tokens,
            "wall_seconds": wall,
            "tok_per_s": new_tokens / max(wall, 1e-9),
            "ttft_s": [r.ttft for r in done],
            "itl_mean_s": itl.sum / itl.count if itl.count else 0.0,
            "itl_p50_s": itl.quantile(0.5) if itl.count else 0.0,
            "itl_p99_s": itl.quantile(0.99) if itl.count else 0.0,
            "decode_steps": self.steps - steps_before,
            "preemptions": self.scheduler.preemptions - preempt0,
            "cache_blocks": self.allocator.num_blocks,
            "cache_peak_blocks": self.allocator.peak_in_use,
            "cache_peak_occupancy": (self.allocator.peak_in_use
                                     / self.allocator.num_blocks),
            "mean_live_occupancy": ((self._occ_sum - occ_sum0) / occ_n
                                    if occ_n else 0.0),
            "cache_bytes": paged_cache_bytes(
                self.cfg, self.plan, self.serve_cfg.num_blocks,
                self.serve_cfg.block_size),
        }

    def metrics_snapshot(self) -> dict:
        """Cheap host-side health snapshot; touches no device state."""
        return {
            "retired": len(self.scheduler.completed),
            "queued": len(self.scheduler.queue),
            "running": len(self.scheduler.running),
            "live_occupancy": self._live_blocks() / self.allocator.num_blocks,
            "preemptions": self.scheduler.preemptions,
            "decode_steps": self.steps,
        }

    def generate(self, prompts, max_new_tokens: int = 32, **kw
                 ) -> List[np.ndarray]:
        """Submit `prompts` (list of 1-D int arrays) in order, drain, and
        return each request's tokens in submission order."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, **kw)
                for p in prompts]
        self.run()
        return [np.asarray(r.out_tokens, np.int32) for r in reqs]


def _decode_step(*args):
    """`decode_step_paged`, looked up when called (so a patched one runs)."""
    return decode_step_paged(*args)


def _prefill_forward(params, cfg, plan, tokens, tlen):
    """The prefill forward of one right-padded request (1, bucket) of true
    length `tlen` (a device scalar): (the logits row at tlen - 1 (1, V),
    k_seq, v_seq (L, S, KV, hd), the cache positions (S,)). The unembed
    runs over the whole bucket, as JAX's `prefill_full` does; only the
    row read is gathered here."""
    logits, _, cache = forward(params, cfg, plan, tokens, make_cache=True)
    kv = cache["kv"]
    return (logits[0].index_select(0, tlen.reshape(1) - 1),
            torch.stack([c.k[0] for c in kv]),
            torch.stack([c.v[0] for c in kv]), kv[0].pos[0])


def _write_rows(pool, kv_bits, k_seq, v_seq, kv_pos, tlen, table_row):
    """JAX's `prefill_write`: the rows at positions < tlen written into
    the pages of `table_row`, the pool in place; the right-pad rows and
    the unwritten ones dropped."""
    pos_row = torch.where((kv_pos >= 0) & (kv_pos < tlen), kv_pos,
                          torch.full_like(kv_pos, -1))
    return write_prefill(pool, k_seq, v_seq, pos_row, table_row,
                         kv_bits=kv_bits)


def recover_runtime(params, cfg, plan, journal_dir: str,
                    serve_cfg: ServeConfig = None, injector=None,
                    fsync: bool = True, device: DeviceLike = None,
                    tracer=None, metrics=None, mesh=None):
    """Crash recovery: rebuild a Runtime from a request journal after a
    process death. Retired requests are never re-run (their tokens live in
    the journal); every in-flight request is re-submitted once under its
    original rid, seed and settings, so draining the returned runtime
    replays each stream token for token. Returns (runtime, journal state);
    `journal_state.completed` holds the pre-crash outputs. `tracer` and
    `metrics` go to the new Runtime. Under a `mesh` every rank replays the
    journal and re-submits the same requests; rank 0 alone writes it."""
    writer = True
    if mesh is not None:
        from repro_torch.dist import world
        writer = world.is_rank0()
        world.barrier()          # the crashed attempt's writes are done
    state = Journal.replay(journal_dir)
    if mesh is not None:
        world.barrier()          # every rank read before rank 0 writes
    journal = Journal(journal_dir, fsync=fsync) if writer else None
    rt = Runtime(params, cfg, plan, serve_cfg, journal=journal,
                 injector=injector, tracer=tracer, metrics=metrics,
                 mesh=mesh, device=device)
    rt.scheduler.advance_rids(state.max_rid)
    for rid in sorted(state.inflight):
        rec = state.inflight[rid]
        req = Request(prompt=np.asarray(rec["prompt"], np.int32),
                      max_new_tokens=rec["max_new_tokens"],
                      temperature=rec["temperature"],
                      top_k=rec["top_k"], top_p=rec["top_p"],
                      stop_tokens=tuple(rec["stop_tokens"]),
                      priority=rec["priority"], seed=rec["seed"])
        rt.scheduler.resubmit(req, rid)
        if journal is not None:
            journal.record_replayed(rid)
    return rt, state
