"""Crash-replay journals (port of `repro.ft.journal`): the serving request
log and the quantization run log share one append-only JSONL record
discipline. File names and record fields are the JAX package's, so each
package reads the other's directories.

`_JsonlJournal` is the shared mechanics: one self-checksummed JSON object
per line (`crc` = crc32 of the record's canonical JSON without the crc
field), `flush` always, `fsync` gating durable records, torn-tail
truncation on reopen, and a monotonic `seq` that survives recovery
generations. A crash mid-append leaves a partial last line, which replay
drops and which reopening for append truncates (else the next append
would merge with it into corrupt non-tail data). A torn or
checksum-failing record before the tail is real corruption and raises
`JournalCorrupt`.

`Journal` (requests.jsonl) is the serving request log: submit /
first_token / retire are fsync-gated, preempt / resume / replayed are
observability only, and `Journal.replay` classifies every submitted rid as
completed or in flight, so recovery re-submits exactly the unfinished
requests.

`QuantJournal` (quant.jsonl + a `leaves/` spill directory) is the
quantization run log. Record kinds:

* ``run_start``   — the run digest plus metadata; fsync-gated. Replay
                    keys leaves to the last run_start, so a fresh run in
                    the same directory invalidates older spills.
* ``leaf_solved`` — (layer, name, resolved-spec digest), the spill file,
                    its payload crc32 and the host err_before / err_after;
                    fsync-gated and written strictly after the spill is
                    durably renamed into place (solve → spill → journal).
* ``layer_done`` / ``resume`` — observability only.
* ``run_done``    — the walk completed; fsync-gated.

Each spilled QTensor is an atomic `ckpt.save_packed_ckpt` file (tmp +
fsync + rename, header + crc32 over the pickled payload), so
`QuantJournal.check_integrity` can assert that every journaled leaf is
present and checksum-valid.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

JOURNAL_NAME = "requests.jsonl"
QUANT_JOURNAL_NAME = "quant.jsonl"
SPILL_DIR = "leaves"


class JournalCorrupt(RuntimeError):
    """A non-tail journal record failed to parse or checksum."""


class ResumeMismatch(ValueError):
    """A resume against a journal written by a different run (arch, policy,
    method, calibration data or mesh changed): resuming would mix
    incompatible codes, so it is refused."""


def _crc(payload: Dict[str, Any]) -> int:
    return zlib.crc32(json.dumps(payload, sort_keys=True).encode())


def _read_records(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL journal, tolerating a torn final record; non-tail
    corruption raises JournalCorrupt."""
    records: List[Dict[str, Any]] = []
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                crc = rec.pop("crc")
                if crc != _crc(rec):
                    raise ValueError("crc mismatch")
            except (ValueError, KeyError, TypeError) as e:
                if i == len(lines) - 1:
                    break        # torn tail: the crash interrupted it
                raise JournalCorrupt(
                    f"{path}: record {i} is corrupt ({e}) but is not "
                    "the tail — the journal was damaged, not torn"
                ) from e
            records.append(rec)
    return records


class _JsonlJournal:
    """Append-only, fsync-gated JSONL log under `directory`."""

    filename = "journal.jsonl"

    def __init__(self, directory: str, fsync: bool = True):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.path = os.path.join(directory, type(self).filename)
        self._fsync = fsync
        self._seq = self._truncate_torn_tail()
        self._f = open(self.path, "a", encoding="utf-8")

    def _truncate_torn_tail(self) -> int:
        """Drop a partial final line left by a crash mid-append; returns
        the number of surviving lines, which seeds `seq`."""
        if not os.path.exists(self.path):
            return 0
        with open(self.path, "r+b") as f:
            data = f.read()
            if data and not data.endswith(b"\n"):
                cut = data.rfind(b"\n") + 1      # 0: wipe a 1-line torn file
                f.truncate(cut)
                data = data[:cut]
        return data.count(b"\n")

    def append(self, ev: str, durable: bool = True, **fields) -> None:
        rec = {"ev": ev, "seq": self._seq, **fields}
        rec["crc"] = _crc(rec)
        self._seq += 1
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        if durable and self._fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class Journal(_JsonlJournal):
    """The serving request log (see the module docstring)."""

    filename = JOURNAL_NAME

    def record_submit(self, req) -> None:
        self.append("submit", rid=req.rid,
                    prompt=[int(t) for t in req.prompt],
                    max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p,
                    stop_tokens=list(req.stop_tokens),
                    priority=req.priority, seed=req.seed)

    def record_first_token(self, req, token: int) -> None:
        self.append("first_token", rid=req.rid, token=int(token))

    def record_retire(self, req) -> None:
        self.append("retire", rid=req.rid,
                    finish_reason=req.finish_reason,
                    tokens=[int(t) for t in req.out_tokens])

    def record_preempt(self, req) -> None:
        self.append("preempt", durable=False, rid=req.rid,
                    emitted=len(req.out_tokens))

    def record_resume(self, req) -> None:
        self.append("resume", durable=False, rid=req.rid,
                    emitted=len(req.out_tokens))

    def record_replayed(self, rid: int) -> None:
        self.append("replayed", durable=False, rid=rid)

    @staticmethod
    def replay(directory: str) -> "JournalState":
        """Parse the journal (a torn final record is dropped) and classify
        every submitted rid as completed or in flight."""
        records = _read_records(os.path.join(directory, JOURNAL_NAME))
        submits: Dict[int, Dict[str, Any]] = {}
        retires: Dict[int, Dict[str, Any]] = {}
        first_tokens: Dict[int, int] = {}
        for rec in records:
            rid = rec.get("rid")
            if rec["ev"] == "submit":
                submits.setdefault(rid, rec)     # idempotent by rid
            elif rec["ev"] == "retire":
                retires[rid] = rec               # last retire wins
            elif rec["ev"] == "first_token":
                first_tokens.setdefault(rid, rec["token"])
        inflight = {rid: rec for rid, rec in submits.items()
                    if rid not in retires}
        max_rid = max(submits, default=-1)
        return JournalState(completed=retires, inflight=inflight,
                            first_tokens=first_tokens, max_rid=max_rid,
                            records=records)


@dataclasses.dataclass
class JournalState:
    completed: Dict[int, Dict[str, Any]]    # rid -> retire record
    inflight: Dict[int, Dict[str, Any]]     # rid -> submit record
    first_tokens: Dict[int, int]            # rid -> TTFT token
    max_rid: int
    records: List[Dict[str, Any]]

    def completed_tokens(self, rid: int) -> Optional[List[int]]:
        rec = self.completed.get(rid)
        return None if rec is None else list(rec["tokens"])


class QuantJournal(_JsonlJournal):
    """The quantization run log + durable per-leaf QTensor spills (see the
    module docstring). The ckpt imports are lazy: ckpt/quantized imports
    core.pipeline, which imports this module."""

    filename = QUANT_JOURNAL_NAME

    def __init__(self, directory: str, fsync: bool = True):
        super().__init__(directory, fsync)
        self.spill_dir = os.path.join(directory, SPILL_DIR)
        os.makedirs(self.spill_dir, exist_ok=True)

    def record_run_start(self, run_digest: int, **meta) -> None:
        self.append("run_start", run=int(run_digest), **meta)

    def spill_leaf(self, layer: int, name: str, qt_host,
                   fault_cb=None) -> Tuple[str, int]:
        """Durably write one solved QTensor (host arrays) as an atomic
        packed-ckpt file; returns (filename, payload crc32). Runs before
        record_leaf: solve → spill → journal."""
        from repro_torch.ckpt.quantized import save_packed_ckpt
        fname = f"L{layer}_{name.replace('/', '_')}.qt"
        crc = save_packed_ckpt(os.path.join(self.spill_dir, fname), qt_host,
                               fault_cb=fault_cb, layer=int(layer),
                               name=str(name))
        return fname, crc

    def record_leaf(self, layer: int, name: str, spec_digest: int,
                    fname: str, crc: int, err_before: float,
                    err_after: float) -> None:
        self.append("leaf_solved", layer=int(layer), name=str(name),
                    spec=int(spec_digest), file=fname, crc32=int(crc),
                    err_before=float(err_before),
                    err_after=float(err_after))

    def record_layer_done(self, layer: int) -> None:
        self.append("layer_done", durable=False, layer=int(layer))

    def record_resume(self, n_leaves: int) -> None:
        self.append("resume", durable=False, leaves=int(n_leaves))

    def record_run_done(self) -> None:
        self.append("run_done")

    @staticmethod
    def replay(directory: str) -> "QuantState":
        """The run state: the last run_start (earlier runs' leaves are
        discarded), journaled leaves keyed (layer, name) last-wins, and
        whether the run completed."""
        records = _read_records(os.path.join(directory, QUANT_JOURNAL_NAME))
        run: Optional[Dict[str, Any]] = None
        leaves: Dict[Tuple[int, str], Dict[str, Any]] = {}
        done = False
        for rec in records:
            if rec["ev"] == "run_start":
                run, leaves, done = rec, {}, False
            elif rec["ev"] == "leaf_solved":
                leaves[(rec["layer"], rec["name"])] = rec
            elif rec["ev"] == "run_done":
                done = True
        return QuantState(run=run, leaves=leaves, done=done, records=records)

    @staticmethod
    def load_leaf(directory: str, rec: Dict[str, Any]):
        """One journaled leaf's spilled QTensor (numpy arrays), validated
        against its header checksum and the crc the journal recorded."""
        from repro_torch.ckpt.quantized import load_packed_ckpt
        path = os.path.join(directory, SPILL_DIR, rec["file"])
        return load_packed_ckpt(path, expect_crc=rec["crc32"])["tree"]

    @staticmethod
    def check_integrity(directory: str) -> int:
        """Assert that every journaled leaf's spill exists and is
        checksum-valid; returns the number of verified leaves. Raises
        PackedCkptError on a missing or corrupt spill."""
        from repro_torch.ckpt.quantized import PackedCkptError
        st = QuantJournal.replay(directory)
        for (layer, name), rec in st.leaves.items():
            try:
                QuantJournal.load_leaf(directory, rec)
            except OSError as e:
                raise PackedCkptError(
                    f"journaled leaf layer {layer} {name!r}: spill "
                    f"{rec['file']!r} unreadable ({e})") from e
        return len(st.leaves)


@dataclasses.dataclass
class QuantState:
    run: Optional[Dict[str, Any]]            # last run_start record
    leaves: Dict[Tuple[int, str], Dict[str, Any]]
    done: bool
    records: List[Dict[str, Any]]
