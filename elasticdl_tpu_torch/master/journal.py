"""Write-ahead job-state journal: the master's crash-survival plane.

A copy of elasticdl_tpu/master/journal.py: the port keeps its own. The
files are the same bytes (records go through the port's codec,
``common/tensor_utils``, which writes what ``msgpack.packb`` writes),
so a journal written by either package recovers in the other, and a
primary of one package and a standby of the other share one journal
directory, its ``fence`` file and its ``journal.lock``.

The paper's fault-tolerance story (dynamic data sharding + task
re-queue + pod relaunch) covers every role except the one that
implements it: ``TaskDispatcher`` keeps ``_todo``/``_doing``, retry
counts, epoch state, and the max-steps budget purely in memory, so a
master crash used to mean a fresh job. This module closes that gap the
same way the checkpoint plane covers worker state — durable,
validated, replayable records:

- **Format**: one append-only file of length-prefixed, CRC32-checksummed
  msgpack records (``[u32 len][u32 crc][payload]``, little-endian).
  A torn tail (crash mid-write) is *truncated, not fatal* — the same
  philosophy as ``checkpoint/state_io.validate_shard_payload``: decode
  success alone is not integrity, so every frame is checksummed and
  every decoded record is shape-validated before replay trusts it.
- **Records**: ``dispatch`` / ``report`` / ``create_tasks`` /
  ``version`` events written through by ``TaskDispatcher`` and
  ``MasterServicer``, plus periodic full-state ``snapshot`` records;
  ``generation`` records fence master incarnations (strictly
  increasing; every task dispatch and RPC response is stamped with the
  current one so workers and late reports can be resolved against the
  incarnation that produced them). ``eval_round``/``eval_fold``
  event-source the evaluation service's round state (open job,
  accumulated raw outputs, ``_last_eval_version``), and ``relaunch``
  records persist the instance manager's gang / row-service relaunch
  generations — the two planes that used to die with the master
  (docs/fault_tolerance.md used to list them as known limitations).
  ``sched`` records event-source the multi-job gang scheduler's job
  table (master/scheduler.py, docs/scheduler.md): submit / schedule /
  run / preempt / resume / done / cancel transitions, so the job table
  survives failover and warm-replays into the standby.
- **Snapshots + compaction**: every ``snapshot_every`` state-mutating
  records the journal captures the dispatcher's full exported state
  and rewrites the file to ``[snapshot, tail…]`` — replay cost is
  bounded by the snapshot cadence, not job length.
- **Replay**: recovery re-runs the recorded operation sequence through
  the *real* dispatcher state machine (``get``/``report``/
  ``create_tasks`` with journaling detached), so the recovered
  dispatcher is equivalent by construction — same todo order, same
  task-id counter, same retry budgets, same counters — rather than a
  parallel reimplementation that could drift. The replay core
  (``apply_replay``) is incremental: a hot standby
  (``master/standby.py``) keeps a warm dispatcher continuously
  replayed by applying only the records appended since its last poll,
  so takeover pays the *tail*, not the journal.

Exactly-once across the crash: tasks leased at crash time replay back
into ``_doing`` and stay leased — the workers holding them ride out
the outage on their RPC retry budget (``--master_reattach_grace``) and
re-report against the recovered master. A report the pre-crash master
had already applied is answered from the dispatcher's bounded
recently-resolved ledger (the same idempotence path that absorbs
at-least-once RPC retries); a report for a task the recovered master
re-queued in the meantime is fenced (``accepted=False``) so the
re-dispatched copy is the only one that counts.

Split-brain fencing (the hot-standby plane): the journal directory
carries a ``fence`` file naming the lowest generation still allowed to
append. A standby taking over publishes ``fence = old_generation + 1``
and only then opens its own generation; every append re-checks the
fence **under an flock on the journal's lock file**, so a zombie
primary's late append is rejected *before any byte lands* — two
incarnations can never interleave records, structurally, not
probabilistically. A fenced append raises ``JournalFencedError``; the
servicer surfaces it as a ``stale_master`` rejection so workers
re-resolve to the new incarnation.
"""

import json
import os
import struct
import threading
import zlib
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger

try:
    import fcntl
except ImportError:  # non-POSIX: fall back to check-without-lock
    fcntl = None

logger = get_logger("master_journal")

JOURNAL_FILE = "journal.log"
FENCE_FILE = "fence"
LOCK_FILE = "journal.lock"

# Record types (the "t" field). KNOWN_TYPES gates replay: an unknown
# type from a newer writer fails loudly instead of silently skewing
# the reconstructed state.
DISPATCH = "dispatch"
REPORT = "report"
CREATE_TASKS = "create_tasks"
VERSION = "version"
SNAPSHOT = "snapshot"
GENERATION = "generation"
RESIZE = "resize"
# Row-plane shard-map epochs (master/row_reshard.py): audit + recovery
# aid riding the same journal. The controller's state file is the
# authoritative copy — compaction may drop old epoch records.
SHARD_MAP = "shard_map"
# Evaluation-round event sourcing (master/evaluation_service.py):
# open / task_done / close round events plus the per-task raw-output
# folds, so an open round survives a master death intact.
EVAL_ROUND = "eval_round"
EVAL_FOLD = "eval_fold"
# Instance-manager relaunch generations (master/instance_manager.py):
# multihost gang restarts and row-service pod relaunches — a recovered
# master must adopt pods under their true (suffixed) names or their
# next death events are discarded as stale.
RELAUNCH = "relaunch"
# Fencing of a prior incarnation at standby takeover: generations must
# be strictly increasing across fence records (fsck enforces).
FENCE = "fence"
# Multi-job gang-scheduler events (master/scheduler.py): the job table
# (spec, priority, gang size, lifecycle state, preemption counts) is
# event-sourced here so it survives failover and replays into the
# standby exactly like the dispatcher/eval/relaunch planes.
SCHED = "sched"
# Streaming-ingestion events (master/stream_ingest.py,
# docs/online_learning.md): partition registration and offset-ranged
# task generation. The committed watermark itself rides REPORT records
# (``stream_partition``/``stream_start``/``stream_end`` stamped by the
# dispatcher) so offset commit is atomic with task resolution — a
# crash cannot ack an offset whose task never resolved, and a
# relaunched pipeline resumes from the journaled watermark, never
# re-acking.
STREAM = "stream"

KNOWN_TYPES = (DISPATCH, REPORT, CREATE_TASKS, VERSION, SNAPSHOT,
               GENERATION, RESIZE, SHARD_MAP, EVAL_ROUND, EVAL_FOLD,
               RELAUNCH, FENCE, SCHED, STREAM)

EVAL_EVENTS = ("open", "close")
RELAUNCH_KINDS = ("gang", "row_service")
# Job lifecycle events: submitted -> scheduled -> running
# -> (preempted -> scheduled -> running)* -> done, plus cancel from
# any non-terminal state.
SCHED_EVENTS = ("submit", "schedule", "run", "preempt", "resume",
                "done", "cancel")
# Stream-plane events: "register" introduces a partition,
# "tasks" records one offset-ranged task generation (replay re-enqueues
# it — stream tasks come from the live tail, not CREATE_TASKS' epoch
# walk, so the journal is their only deterministic source).
STREAM_EVENTS = ("register", "tasks")

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)


class JournalFormatError(RuntimeError):
    """A record *before* the tail failed validation — unlike a torn
    tail (expected after a crash, silently truncated), mid-file
    corruption means the journal cannot be trusted."""


class JournalFencedError(RuntimeError):
    """This incarnation has been fenced by a newer one (hot-standby
    takeover): its appends are rejected before any byte lands. The
    process must stop serving — its in-memory state is no longer the
    job's truth."""


def _pending_resize_from(record: dict) -> Optional[dict]:
    """Pending-barrier state a RESIZE record (or append fields) leaves
    behind: the begin fields while open, None once done. One helper so
    open/append/replay cannot drift on the record shape."""
    if record.get("done"):
        return None
    return {
        k: record[k] for k in ("resize_id", "spec", "direction")
        if k in record
    }


# ---- eval-round / relaunch state folding --------------------------------
#
# The journal mirrors the evaluation service's round state and the
# instance manager's relaunch generations the same way it mirrors the
# model-version high-water mark: tracked at append time (so snapshots
# can carry them through compaction), re-derived at open_generation
# scan, and rebuilt by replay — all through ONE fold function per
# plane, so the three paths cannot drift on the record shape.


def new_eval_state() -> dict:
    return {"open": None, "last_eval_version": -1, "results": {}}


def _implicit_open() -> dict:
    # Eval-only jobs open their round at construction (the
    # deterministic base state, never journaled) — progress tracks
    # against an implicit open round.
    return {"model_version": -1, "total_tasks": -1,
            "completed": 0, "folds": []}


def apply_eval_record(state: dict, record: dict):
    rtype = record["t"]
    if rtype == EVAL_ROUND:
        event = record.get("event")
        if event == "open":
            state["open"] = {
                "model_version": int(record.get("model_version", -1)),
                "total_tasks": int(record.get("total_tasks", -1)),
                "completed": 0,
                "folds": [],
            }
            state["last_eval_version"] = int(
                record.get("last_eval_version",
                           record.get("model_version", -1))
            )
        elif event == "close":
            state["results"][int(record.get("model_version", -1))] = (
                record.get("results") or {}
            )
            state["open"] = None
    elif rtype == EVAL_FOLD:
        if state["open"] is None:
            state["open"] = _implicit_open()
        state["open"]["folds"].append([
            int(record.get("task_id", -1)),
            record.get("outputs"),
            record.get("labels"),
        ])


def apply_eval_report_record(state: dict, record: dict):
    """Fold one REPORT record's eval-completion side effect into the
    eval state. Completion rides the REPORT record itself
    (``task_type``/``model_version``/``requeued`` fields stamped by
    the dispatcher) rather than a second journal append, so a crash
    between "task resolved" and "round progressed" is impossible —
    they are one fsynced record. Mirrors the servicer's
    ``complete_task`` call: a resolution counts unless the task was
    re-queued, and a completion from a different round's version must
    not count toward this one."""
    if record.get("task_type") != "evaluation" or record.get("requeued"):
        return
    model_version = int(record.get("model_version", -1))
    if state["open"] is None:
        if model_version >= 0:
            # A versioned eval task resolving with no open round is a
            # straggler from an already-closed round — the live path
            # (complete_task with no job) ignores it too.
            return
        state["open"] = _implicit_open()
    open_round = state["open"]
    if (model_version >= 0 and open_round["model_version"] >= 0
            and model_version != open_round["model_version"]):
        return
    open_round["completed"] += 1


def new_sched_state() -> dict:
    return {"jobs": {}, "preemptions": 0}


def apply_sched_record(state: dict, record: dict):
    """Fold one SCHED event into the job table — the ONE fold function
    shared by live appends (journal-side mirror), the open-generation
    scan, and replay, so the three paths cannot drift on the record
    shape (same discipline as the eval/relaunch planes)."""
    event = record.get("event")
    job = str(record.get("job", ""))
    jobs = state["jobs"]
    if event == "submit":
        jobs[job] = {
            "spec": dict(record.get("spec") or {}),
            "priority": int(record.get("priority", 0)),
            "gang_size": int(record.get("gang_size", 1)),
            "state": "submitted",
            "preemptions": 0,
        }
        return
    entry = jobs.get(job)
    if entry is None:
        # An event for a job the (compacted) prefix no longer names —
        # replay tolerates it (the snapshot's table supersedes), the
        # live scheduler never produces it.
        return
    if event == "schedule" or event == "resume":
        entry["state"] = "scheduled"
    elif event == "run":
        entry["state"] = "running"
    elif event == "preempt":
        entry["state"] = "preempted"
        entry["preemptions"] = int(entry.get("preemptions", 0)) + 1
        state["preemptions"] = int(state.get("preemptions", 0)) + 1
    elif event == "done":
        entry["state"] = "done"
    elif event == "cancel":
        entry["state"] = "cancelled"


def new_relaunch_state() -> dict:
    return {"gang": 0, "row_service": {}}


def apply_relaunch_record(state: dict, record: dict):
    generation = int(record.get("generation", 0))
    if record.get("kind") == "gang":
        state["gang"] = max(state["gang"], generation)
    else:
        shard = int(record.get("shard", 0))
        state["row_service"][shard] = max(
            state["row_service"].get(shard, 0), generation
        )


def new_stream_state() -> dict:
    """Per-partition ingestion progress: ``next`` (first offset no
    task has been generated for), ``committed`` (exclusive watermark —
    every offset below it resolved successfully and durably), and
    ``pending`` (resolved ranges still ahead of the contiguous
    committed prefix, {start: end} — tasks complete out of order)."""
    return {"partitions": {}}


def _stream_partition(state: dict, partition: str) -> dict:
    part = state["partitions"].get(partition)
    if part is None:
        part = {"committed": 0, "next": 0, "pending": {}}
        state["partitions"][partition] = part
    return part


def advance_stream_watermark(part: dict, start: int, end: int):
    """Fold one successfully-resolved offset range [start, end) into a
    partition's watermark: record it as pending, then advance
    ``committed`` across the contiguous resolved prefix. Shared by the
    dispatcher's live accounting and every journal fold path so the
    watermark algebra cannot drift. Idempotent for replayed ranges at
    or below the watermark (recovery re-folds are no-ops)."""
    start, end = int(start), int(end)
    if end <= start or end <= int(part["committed"]):
        return
    pending = part["pending"]
    prev = pending.get(start)
    if prev is None or prev < end:
        pending[start] = end
    committed = int(part["committed"])
    while committed in pending:
        committed = pending.pop(committed)
    part["committed"] = committed


def apply_stream_record(state: dict, record: dict):
    """Fold one STREAM event — the ONE fold function shared by live
    appends (journal-side mirror), the open-generation scan, and
    replay (same discipline as the eval/relaunch/sched planes)."""
    partition = str(record.get("partition", ""))
    part = _stream_partition(state, partition)
    if record.get("event") == "tasks":
        part["next"] = max(int(part["next"]), int(record.get("end", 0)))


def apply_stream_report_record(state: dict, record: dict):
    """Fold one REPORT record's offset-commit side effect. The commit
    rides the REPORT record itself (``stream_*`` fields stamped by the
    dispatcher) rather than a second append, so a crash between "task
    resolved" and "watermark advanced" is impossible — they are one
    fsynced record. A failed or re-queued task commits nothing: its
    range stays uncommitted until the retry resolves."""
    partition = record.get("stream_partition")
    if not partition or not record.get("success") \
            or record.get("requeued"):
        return
    advance_stream_watermark(
        _stream_partition(state, str(partition)),
        record.get("stream_start", 0), record.get("stream_end", 0),
    )


def normalize_stream_state(state) -> dict:
    """Snapshot/json round-trip normalization (pending keys may come
    back as strings from json-sourced snapshots)."""
    out = new_stream_state()
    for partition, part in (state or {}).get("partitions", {}).items():
        out["partitions"][str(partition)] = {
            "committed": int(part.get("committed", 0)),
            "next": int(part.get("next", 0)),
            "pending": {
                int(k): int(v)
                for k, v in (part.get("pending") or {}).items()
            },
        }
    return out


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def read_records(path: str, start: int = 0):
    """Yield ``(offset, end, record)`` for every intact frame from
    byte ``start``; stop at the first torn/corrupt frame (crash
    tail). The caller decides whether to truncate (recovery) or
    report (fsck) — this reader never raises on a bad tail, only on
    unreadable files. ``start`` must be a frame boundary a previous
    read returned (the standby's incremental tail read); the CRC +
    shape gates make a stale boundary read as an empty tail, never as
    garbage records."""
    with open(path, "rb") as fh:
        blob = fh.read()
    offset = int(start)
    while offset + _HEADER.size <= len(blob):
        length, crc = _HEADER.unpack_from(blob, offset)
        start = offset + _HEADER.size
        payload = blob[start:start + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            return  # torn tail: partial frame or checksum mismatch
        try:
            record = tensor_utils.loads(payload)
        except Exception:
            return  # undecodable despite matching crc: treat as tail
        if not isinstance(record, dict) or "t" not in record:
            return
        yield offset, start + length, record
        offset = start + length


def validate_record(record: dict) -> Optional[str]:
    """Structural check on one decoded record (the journal's analogue
    of ``state_io.validate_shard_payload``). Returns an error string
    or None."""
    rtype = record.get("t")
    if rtype not in KNOWN_TYPES:
        return f"unknown record type {rtype!r}"
    if not isinstance(record.get("seq"), int):
        return f"{rtype}: non-int seq"
    if rtype == DISPATCH:
        if not isinstance(record.get("task"), dict):
            return "dispatch: task is not a dict"
        for key in ("task_id", "worker_id", "generation"):
            if not isinstance(record.get(key), int):
                return f"dispatch: non-int {key}"
    elif rtype == REPORT:
        if not isinstance(record.get("task_id"), int):
            return "report: non-int task_id"
        if not isinstance(record.get("success"), bool):
            return "report: non-bool success"
        if "stream_partition" in record:
            if not isinstance(record["stream_partition"], str):
                return "report: non-str stream_partition"
            for key in ("stream_start", "stream_end"):
                if not isinstance(record.get(key), int):
                    return f"report: non-int {key}"
    elif rtype == CREATE_TASKS:
        if not isinstance(record.get("task_type"), str):
            return "create_tasks: non-str task_type"
    elif rtype == VERSION:
        if not isinstance(record.get("model_version"), int):
            return "version: non-int model_version"
    elif rtype in (GENERATION, FENCE):
        if not isinstance(record.get("generation"), int):
            return f"{rtype}: non-int generation"
    elif rtype == RESIZE:
        if not isinstance(record.get("resize_id"), int):
            return "resize: non-int resize_id"
        if not isinstance(record.get("spec"), dict):
            return "resize: spec is not a dict"
        if not isinstance(record.get("done"), bool):
            return "resize: non-bool done"
    elif rtype == SHARD_MAP:
        if not isinstance(record.get("version"), int):
            return "shard_map: non-int version"
        if not isinstance(record.get("map"), dict):
            return "shard_map: map is not a dict"
    elif rtype == EVAL_ROUND:
        if record.get("event") not in EVAL_EVENTS:
            return f"eval_round: unknown event {record.get('event')!r}"
        if not isinstance(record.get("model_version"), int):
            return "eval_round: non-int model_version"
        if (record.get("event") == "open"
                and not isinstance(record.get("total_tasks"), int)):
            return "eval_round: open without int total_tasks"
    elif rtype == EVAL_FOLD:
        if not isinstance(record.get("task_id"), int):
            return "eval_fold: non-int task_id"
    elif rtype == RELAUNCH:
        if record.get("kind") not in RELAUNCH_KINDS:
            return f"relaunch: unknown kind {record.get('kind')!r}"
        if not isinstance(record.get("generation"), int):
            return "relaunch: non-int generation"
        if (record.get("kind") == "row_service"
                and not isinstance(record.get("shard"), int)):
            return "relaunch: row_service without int shard"
    elif rtype == SCHED:
        if record.get("event") not in SCHED_EVENTS:
            return f"sched: unknown event {record.get('event')!r}"
        if not isinstance(record.get("job"), str) or not record["job"]:
            return "sched: missing job id"
        if (record.get("event") == "submit"
                and not isinstance(record.get("spec"), dict)):
            return "sched: submit without spec dict"
    elif rtype == STREAM:
        if record.get("event") not in STREAM_EVENTS:
            return f"stream: unknown event {record.get('event')!r}"
        if not isinstance(record.get("partition"), str) \
                or not record["partition"]:
            return "stream: missing partition"
        if record.get("event") == "tasks":
            for key in ("start", "end"):
                if not isinstance(record.get(key), int):
                    return f"stream: tasks without int {key}"
            if record["end"] <= record["start"]:
                return "stream: empty tasks range"
    elif rtype == SNAPSHOT:
        state = record.get("state")
        if not isinstance(state, dict):
            return "snapshot: state is not a dict"
        for key in ("todo", "doing"):
            if not isinstance(state.get(key), list):
                return f"snapshot: state.{key} is not a list"
        for key in ("task_id", "epochs_todo"):
            if not isinstance(state.get(key), int):
                return f"snapshot: state.{key} is not an int"
    return None


def new_replay_carry() -> dict:
    """Accumulator ``apply_replay`` folds records into — everything a
    recovered (or continuously-replaying standby) master needs beyond
    the dispatcher itself."""
    return {
        "replayed": 0,
        "snapshot": False,
        "model_version": 0,
        "generation": 0,
        "known_workers": set(),
        "resize": None,
        "shard_map": None,
        "eval": new_eval_state(),
        "relaunch": new_relaunch_state(),
        "sched": new_sched_state(),
        "stream": new_stream_state(),
        "seq": 0,
    }


def apply_replay(dispatcher, records: List[dict],
                 carry: Optional[dict] = None) -> dict:
    """Fold ``records`` into ``dispatcher`` + ``carry`` — the replay
    core shared by cold recovery (``recover_into``: all records into a
    fresh dispatcher) and the hot standby (only the records appended
    since its last poll, into its warm dispatcher).

    Records with ``seq <= carry["seq"]`` are skipped (already
    applied); a SNAPSHOT with a newer seq supersedes the dispatcher's
    current state wholesale (that is what a snapshot means), so the
    incremental path survives compaction rewrites. The dispatcher must
    NOT have a journal attached — replay drives its real ``get``/
    ``report``/``create_tasks`` methods and must not re-append what it
    reads.
    """
    if getattr(dispatcher, "_journal", None) is not None:
        raise RuntimeError("detach the journal before replay")
    carry = carry if carry is not None else new_replay_carry()
    for record in records:
        seq = int(record.get("seq", 0))
        if seq <= carry["seq"]:
            continue
        carry["seq"] = seq
        rtype = record["t"]
        if rtype == GENERATION or rtype == FENCE:
            carry["generation"] = max(carry["generation"],
                                      record["generation"])
            continue
        if rtype == SHARD_MAP:
            # Newest epoch wins (versions are monotonic by
            # construction — the authority is the only writer).
            carry["shard_map"] = record["map"]
            carry["replayed"] += 1
            continue
        if rtype == VERSION:
            carry["model_version"] = max(carry["model_version"],
                                         record["model_version"])
            worker_id = int(record.get("worker_id", -1))
            if worker_id >= 0:
                dispatcher.record_worker_version(
                    worker_id, record["model_version"]
                )
                carry["known_workers"].add(worker_id)
            carry["replayed"] += 1
            continue
        if rtype == RESIZE:
            # Barrier state, not dispatcher state: an open begin
            # survives so the recovered servicer re-offers the
            # directive; done closes it.
            carry["resize"] = _pending_resize_from(record)
            carry["replayed"] += 1
            continue
        if rtype in (EVAL_ROUND, EVAL_FOLD):
            apply_eval_record(carry["eval"], record)
            carry["replayed"] += 1
            continue
        if rtype == RELAUNCH:
            apply_relaunch_record(carry["relaunch"], record)
            carry["replayed"] += 1
            continue
        if rtype == SCHED:
            apply_sched_record(carry["sched"], record)
            carry["replayed"] += 1
            continue
        if rtype == STREAM:
            apply_stream_record(carry["stream"], record)
            # Stream tasks are generated from the live tail, not the
            # epoch walk — replay re-enqueues them from the journal so
            # the subsequent DISPATCH records find the same todo queue
            # the dead master had.
            if record.get("event") == "tasks":
                dispatcher.create_stream_tasks(
                    record["partition"], record["start"], record["end"],
                    model_version=record.get("model_version", -1),
                )
            else:
                dispatcher.register_stream_partition(
                    record["partition"]
                )
            carry["replayed"] += 1
            continue
        if rtype == SNAPSHOT:
            state = record["state"]
            dispatcher.restore_state(state)
            carry["snapshot"] = True
            carry["generation"] = max(carry["generation"],
                                      int(record.get("generation", 0)))
            carry["model_version"] = max(
                carry["model_version"],
                int(record.get("model_version", 0)),
            )
            carry["resize"] = record.get("resize")
            if record.get("eval") is not None:
                carry["eval"] = record["eval"]
            if record.get("relaunch") is not None:
                # msgpack round-trips the shard keys as ints already,
                # but normalize defensively (json-sourced snapshots).
                relaunch = record["relaunch"]
                carry["relaunch"] = {
                    "gang": int(relaunch.get("gang", 0)),
                    "row_service": {
                        int(k): int(v) for k, v in
                        (relaunch.get("row_service") or {}).items()
                    },
                }
            if record.get("sched") is not None:
                sched = record["sched"]
                carry["sched"] = {
                    "jobs": {
                        str(k): dict(v) for k, v in
                        (sched.get("jobs") or {}).items()
                    },
                    "preemptions": int(sched.get("preemptions", 0)),
                }
            if record.get("stream") is not None:
                carry["stream"] = normalize_stream_state(
                    record["stream"]
                )
            # Compaction dropped the pre-snapshot dispatch records;
            # the snapshot's leases and version reports still name the
            # workers this job had.
            carry["known_workers"].update(
                int(wid) for _tid, _task, wid in state.get("doing", [])
            )
            carry["known_workers"].update(
                int(k) for k in state.get("worker_version", {})
            )
            carry["replayed"] += 1
            continue
        if rtype == CREATE_TASKS:
            dispatcher.create_tasks(
                record["task_type"],
                model_version=record.get("model_version", -1),
            )
            carry["replayed"] += 1
            continue
        if rtype == DISPATCH:
            wid = record["worker_id"]
            carry["known_workers"].add(wid)
            task = dispatcher.get(wid)
            want = record["task"]
            if task is None or task.task_id != record["task_id"] or (
                (task.shard_name, task.start, task.end, task.type)
                != (want.get("shard_name"), want.get("start"),
                    want.get("end"), want.get("type"))
            ):
                # The state machine disagreed with the journal —
                # a bug or a journal from different job config.
                # Fail loudly; recovering wrong state silently
                # would double- or under-train.
                raise JournalFormatError(
                    f"replay diverged at seq {record['seq']}: "
                    f"journal dispatched task {record['task_id']} "
                    f"({want.get('shard_name')}:{want.get('start')}-"
                    f"{want.get('end')}), state machine produced "
                    f"{task.task_id if task else None}"
                )
            carry["replayed"] += 1
            continue
        if rtype == REPORT:
            dispatcher.report(
                record["task_id"], record["success"],
                err_reason=record.get("err_reason", ""),
            )
            # The eval-completion and stream-commit side effects ride
            # the same record (atomic with the resolution — a crash
            # cannot separate them).
            apply_eval_report_record(carry["eval"], record)
            apply_stream_report_record(carry["stream"], record)
            carry["replayed"] += 1
    return carry


class MasterJournal:
    """One job's journal: append with periodic snapshot/compaction,
    replay with torn-tail truncation. Thread-safe (appends come from
    dispatcher and servicer threads)."""

    def __init__(self, journal_dir: str, snapshot_every: int = 64):
        if not journal_dir:
            raise ValueError("journal_dir must be non-empty")
        self.journal_dir = journal_dir
        self.snapshot_every = max(1, int(snapshot_every))
        os.makedirs(journal_dir, exist_ok=True)
        self.path = os.path.join(journal_dir, JOURNAL_FILE)
        self.fence_path = os.path.join(journal_dir, FENCE_FILE)
        self.lock_path = os.path.join(journal_dir, LOCK_FILE)
        self._lock = threading.RLock()
        self._fh = None
        self._seq = 0
        self._since_snapshot = 0
        # Provider returning the dispatcher's exported state; called
        # with the dispatcher lock already held (appends happen inside
        # the dispatcher's critical sections), so it must be the
        # lock-free variant (TaskDispatcher._export_state_locked).
        self._snapshot_provider: Optional[Callable[[], dict]] = None
        self.generation = 0
        # Model-version high-water mark, tracked journal-side so
        # compaction (which discards the raw VERSION records) can
        # carry it inside the snapshot record.
        self._model_version = 0
        # Pending resize barrier (master/servicer.py), tracked the
        # same way: the open begin record must survive compaction so
        # a recovered master can re-offer the directive.
        self._pending_resize = None
        # Evaluation-round and relaunch-generation mirrors, tracked
        # journal-side for the same reason (compaction must not drop
        # an open round or a live pod generation). Folded through the
        # SAME functions replay uses, so they cannot drift.
        self._eval = new_eval_state()
        self._relaunch = new_relaunch_state()
        self._sched = new_sched_state()
        self._stream = new_stream_state()
        # (last-checked monotonic time, verdict) for is_fenced().
        self._fence_cache = (0.0, False)

    # ---- lifecycle -----------------------------------------------------

    def has_state(self) -> bool:
        """True when the journal holds at least one intact record —
        i.e. a restarted master has something to recover."""
        if not os.path.exists(self.path):
            return False
        for _offset, _end, _record in read_records(self.path):
            return True
        return False

    def set_snapshot_provider(self, provider: Callable[[], dict]):
        self._snapshot_provider = provider

    def open_generation(self) -> int:
        """Start (or resume) this master incarnation: scan for the
        highest generation on disk, truncate any torn tail, open with
        ``max(generation + 1, fence file)``, and PUBLISH that fence —
        opening a generation always fences every prior incarnation, so
        a restarted old primary coming back next to a promoted standby
        produces a single-writer handover (last opener wins; the other
        side's next append is rejected), never two live masters
        interleaving records. The whole scan→fence→first-append runs
        under the journal flock, so two racing openers serialize: the
        second sees the first's generation record and lands above it.
        Returns the new generation. Raises if the fence file exists
        but is unreadable — opening under an unknown fence could
        resurrect a fenced incarnation."""
        with self._lock:
            fd = self._flock()
            try:
                return self._open_generation_flocked()
            finally:
                self._funlock(fd)

    def _open_generation_flocked(self) -> int:
            last_good_end = 0
            max_gen = -1
            if os.path.exists(self.path):
                for _offset, end, record in read_records(self.path):
                    last_good_end = end
                    self._seq = max(self._seq, int(record.get("seq", 0)))
                    if record["t"] in (GENERATION, FENCE):
                        max_gen = max(
                            max_gen, int(record.get("generation", -1))
                        )
                    elif record["t"] == VERSION:
                        self._model_version = max(
                            self._model_version,
                            int(record.get("model_version", 0)),
                        )
                    elif record["t"] == SNAPSHOT:
                        self._model_version = max(
                            self._model_version,
                            int(record.get("model_version", 0)),
                        )
                        self._pending_resize = record.get("resize")
                        if record.get("eval") is not None:
                            self._eval = record["eval"]
                        if record.get("relaunch") is not None:
                            self._relaunch = record["relaunch"]
                        if record.get("sched") is not None:
                            self._sched = record["sched"]
                        if record.get("stream") is not None:
                            self._stream = normalize_stream_state(
                                record["stream"]
                            )
                    elif record["t"] == RESIZE:
                        self._pending_resize = _pending_resize_from(
                            record
                        )
                    elif record["t"] in (EVAL_ROUND, EVAL_FOLD):
                        apply_eval_record(self._eval, record)
                    elif record["t"] == REPORT:
                        # Round progress and stream commits ride
                        # report records — the scan must fold them
                        # like append/replay do, or this incarnation's
                        # next snapshot regresses the mirrored state.
                        apply_eval_report_record(self._eval, record)
                        apply_stream_report_record(self._stream, record)
                    elif record["t"] == RELAUNCH:
                        apply_relaunch_record(self._relaunch, record)
                    elif record["t"] == SCHED:
                        apply_sched_record(self._sched, record)
                    elif record["t"] == STREAM:
                        apply_stream_record(self._stream, record)
                size = os.path.getsize(self.path)
                if size > last_good_end:
                    logger.warning(
                        "journal %s: truncating torn tail "
                        "(%d byte(s) past the last intact record)",
                        self.path, size - last_good_end,
                    )
                    with open(self.path, "r+b") as fh:
                        fh.truncate(last_good_end)
            # An existing fence wins over the on-disk generation scan:
            # a takeover published fence = old + 1 BEFORE opening, and
            # the opener must land exactly on it (never below — that
            # incarnation would be stillborn, its own appends fenced).
            # strict=True: an unreadable fence must abort the open,
            # not be adopted as a generation.
            self.generation = max(max_gen + 1,
                                  self._read_fence(strict=True))
            self._write_fence_file(self.generation)
            self._fence_cache = (0.0, False)  # verdict was per old gen
            self._fh = open(self.path, "ab")
            self._append_frame(GENERATION, generation=self.generation)
            return self.generation

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # ---- fencing (hot-standby takeover) --------------------------------

    def _read_fence(self, strict: bool = False) -> int:
        try:
            with open(self.fence_path) as fh:
                return int(json.load(fh).get("generation", 0))
        except FileNotFoundError:
            return 0
        except Exception:
            logger.exception("unreadable fence file %s", self.fence_path)
            if strict:
                # open_generation must never adopt the fail-closed
                # sentinel as its own generation (that would un-fence
                # exactly the case the sentinel blocks).
                raise RuntimeError(
                    f"fence file {self.fence_path} exists but is "
                    "unreadable; refusing to open a generation under "
                    "an unknown fence"
                )
            # An unreadable fence fails CLOSED: nobody can prove they
            # are the live incarnation, so nobody may append.
            return 1 << 62

    def fence_generation(self) -> int:
        """Lowest generation still allowed to append (0 = unfenced)."""
        return self._read_fence()

    def _write_fence_file(self, generation: int) -> int:
        """Durably publish ``max(current fence, generation)`` (caller
        holds the flock). Returns the published value."""
        generation = max(int(generation), self._read_fence())
        tmp = self.fence_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"generation": generation}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.fence_path)
        return generation

    def is_fenced(self) -> bool:
        """Cheap pre-check for RPC handlers (the authoritative reject
        happens inside ``append`` under the flock). Cached briefly —
        one fence-file stat per ~100ms, not per WAIT poll — and
        sticky: once fenced, always fenced (fences never regress)."""
        import time

        now = time.monotonic()
        t, fenced = self._fence_cache
        if fenced:
            return True
        if now - t < 0.1:
            return False
        fenced = self.fence_generation() > self.generation
        self._fence_cache = (now, fenced)
        return fenced

    def _flock(self):
        """Exclusive lock on the journal's lock file (cross-process
        AND cross-instance-in-process: flock contends per open file
        description). Returns the fd, or None when flock is
        unavailable (fence checks still run, just not atomically)."""
        if fcntl is None:
            return None
        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except Exception:
            os.close(fd)
            return None
        return fd

    @staticmethod
    def _funlock(fd):
        if fd is not None:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

    def publish_fence(self, generation: int) -> int:
        """Fence every incarnation below ``generation`` (standby
        takeover step 1 — BEFORE opening our own generation). Under
        the flock, so it serializes against in-flight appends: once
        this returns, no fenced incarnation can land another byte.
        Monotonic: an older fence is never regressed. Returns the
        published fence generation."""
        fd = self._flock()
        try:
            return self._write_fence_file(generation)
        finally:
            self._funlock(fd)

    # ---- append --------------------------------------------------------

    def _check_fence_flocked(self, action: str):
        """Caller holds the flock: reject if a newer incarnation owns
        the journal."""
        fence = self.fence_generation()
        if fence > self.generation:
            raise JournalFencedError(
                f"incarnation (generation {self.generation}) is "
                f"fenced by generation {fence}: {action} rejected — "
                "a newer master owns this journal"
            )

    def _append_frame(self, rtype: str, **fields):
        """Write + fsync one frame. Caller holds the flock (or is the
        opener inside open_generation's flock)."""
        if self._fh is None:
            raise RuntimeError(
                "journal not open for append (call open_generation)"
            )
        self._seq += 1
        record = {"t": rtype, "seq": self._seq, **fields}
        self._fh.write(_frame(tensor_utils.dumps(record)))
        self._fh.flush()
        # fsync per record: exactly-once across NODE failure requires
        # the record durable before the RPC response leaves (a
        # flushed-but-unsynced report acked to the worker would
        # re-train after power loss). Affordable here — the control
        # plane appends at task granularity (seconds), not step
        # granularity.
        os.fsync(self._fh.fileno())

    def _append_locked(self, rtype: str, **fields):
        fd = self._flock()
        try:
            self._check_fence_flocked(f"append of {rtype!r}")
            self._append_frame(rtype, **fields)
        finally:
            self._funlock(fd)

    def append(self, rtype: str, **fields):
        """Append one event record; dispatcher-originated state
        mutations (dispatch/report) also advance the snapshot cadence
        — those are the only appends guaranteed to run under the
        dispatcher lock, which the snapshot provider requires."""
        with self._lock:
            if rtype == VERSION:
                self._model_version = max(
                    self._model_version,
                    int(fields.get("model_version", 0)),
                )
            elif rtype == RESIZE:
                self._pending_resize = _pending_resize_from(fields)
            elif rtype in (EVAL_ROUND, EVAL_FOLD):
                apply_eval_record(self._eval, {"t": rtype, **fields})
            elif rtype == REPORT:
                # Eval-round completion and stream-offset commits ride
                # the report record (see apply_eval_report_record /
                # apply_stream_report_record) — mirror them here so
                # the snapshot carries the progress.
                apply_eval_report_record(self._eval, fields)
                apply_stream_report_record(self._stream, fields)
            elif rtype == RELAUNCH:
                apply_relaunch_record(self._relaunch, fields)
            elif rtype == SCHED:
                apply_sched_record(self._sched, fields)
            elif rtype == STREAM:
                apply_stream_record(self._stream, {"t": rtype, **fields})
            self._append_locked(rtype, **fields)
            if rtype in (DISPATCH, REPORT):
                self._since_snapshot += 1
                if (self._snapshot_provider is not None
                        and self._since_snapshot >= self.snapshot_every):
                    self._snapshot_locked()

    def _snapshot_locked(self):
        state = self._snapshot_provider()
        self._seq += 1
        record = {
            "t": SNAPSHOT, "seq": self._seq,
            "generation": self.generation, "state": state,
            # Compaction discards the raw VERSION records; the
            # high-water mark must survive inside the snapshot.
            "model_version": int(self._model_version),
            # Same for an open resize barrier, an open eval round, and
            # the relaunch generations (their raw records are
            # compacted away with the rest of the prefix).
            "resize": self._pending_resize,
            "eval": self._eval,
            "relaunch": self._relaunch,
            "sched": self._sched,
            "stream": self._stream,
        }
        # Compaction: the snapshot supersedes everything before it, so
        # rewrite the file as [generation fence, snapshot] and keep
        # appending — replay cost stays bounded by the cadence. The
        # tmp+rename publish mirrors the checkpoint saver: a crash
        # mid-compaction leaves either the old journal or the new one,
        # never a half-written file. The whole rewrite runs under the
        # flock WITH a fence re-check: os.replace would otherwise let
        # a freshly-fenced zombie clobber records the new incarnation
        # appended after this zombie's last fence check — the one
        # remaining way around the append-path fence.
        fd = self._flock()
        try:
            self._check_fence_flocked("snapshot compaction")
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as fh:
                fence = {
                    "t": GENERATION, "seq": self._seq - 1,
                    "generation": self.generation,
                }
                fh.write(_frame(tensor_utils.dumps(fence)))
                fh.write(_frame(tensor_utils.dumps(record)))
                fh.flush()
                os.fsync(fh.fileno())
            if self._fh is not None:
                self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
            self._since_snapshot = 0
        finally:
            self._funlock(fd)

    # ---- replay --------------------------------------------------------

    def head_signature(self) -> Optional[tuple]:
        """(seq, type) of the FIRST intact record, or None. One-frame
        decode: the standby's incremental reader uses it to detect a
        compaction rewrite (the head changes) without re-decoding the
        file."""
        if not os.path.exists(self.path):
            return None
        for _offset, _end, record in read_records(self.path):
            return (int(record.get("seq", 0)), record.get("t"))
        return None

    def last_seq(self) -> int:
        """Highest intact seq, decoding ONLY the final frame: frames
        are hopped by their length headers (CRC-checked, no msgpack
        work), so a lag probe on a snapshot-heavy journal costs I/O,
        not an ndarray decode per beat."""
        if not os.path.exists(self.path):
            return 0
        with open(self.path, "rb") as fh:
            blob = fh.read()
        offset = 0
        last_payload = None
        while offset + _HEADER.size <= len(blob):
            length, crc = _HEADER.unpack_from(blob, offset)
            start = offset + _HEADER.size
            payload = blob[start:start + length]
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            last_payload = payload
            offset = start + length
        if last_payload is None:
            return 0
        try:
            record = tensor_utils.loads(last_payload)
            return int(record.get("seq", 0))
        except Exception:
            return 0

    def replay_records(self) -> List[dict]:
        """All intact records, torn tail dropped; raises
        ``JournalFormatError`` only on structurally invalid records
        *before* the tail (a bad frame is the tail by definition —
        framing cannot resync past it)."""
        if not os.path.exists(self.path):
            return []
        out = []
        for _offset, _end, record in read_records(self.path):
            err = validate_record(record)
            if err:
                raise JournalFormatError(f"{self.path}: {err}")
            out.append(record)
        return out

    def tail(self, n: int = 50) -> List[dict]:
        """Last ``n`` intact records — the incident bundle's
        ``journal_tail.json`` (observability/slo.IncidentRecorder):
        what the control plane was doing right before a breach.
        Read-only and crash-tolerant (torn tails drop, bad records
        return what precedes them rather than raising — an incident
        capture must never fail on a journal quirk)."""
        if not os.path.exists(self.path):
            return []
        out: List[dict] = []
        try:
            for _offset, _end, record in read_records(self.path):
                out.append(record)
        except Exception:
            logger.exception("journal tail read stopped early")
        return out[-int(n):]

    def recover_into(self, dispatcher) -> dict:
        """Replay the full journal into ``dispatcher`` (freshly
        constructed with the same shard/epoch/seed config). Returns
        the replay carry (``replayed``, ``snapshot``,
        ``model_version``, ``generation``, sorted ``known_workers``,
        ``resize``, ``shard_map``, ``eval``, ``relaunch``)."""
        carry = apply_replay(dispatcher, self.replay_records())
        # Leases survive the crash: tasks in doing stay leased to the
        # workers riding out the outage; their start clocks reset to
        # replay time (dispatcher.get stamped time.time()), so the
        # straggler deadline counts from recovery, and a worker that
        # died DURING the outage is caught by the normal timeout path.
        carry["known_workers"] = sorted(carry["known_workers"])
        return carry


def rearm_recovered_master(journal: "MasterJournal", dispatcher,
                           stats: dict, servicer=None,
                           eval_service=None) -> None:
    """Re-arm the control plane around a replayed dispatcher after the
    new generation is open: journal write-through re-attached, eval
    round restored, servicer high-water marks / straggler clocks /
    pending resize re-offered. One function so cold recovery
    (``recover_master_state``) and the hot standby's warm takeover
    (``master/standby.py``) cannot drift on the sequence."""
    dispatcher.attach_journal(journal)
    if eval_service is not None:
        eval_service.restore_recovered(stats["eval"])
        eval_service.attach_journal(journal)
    if servicer is not None:
        servicer.model_version = max(
            servicer.model_version, stats["model_version"]
        )
        servicer.generation = journal.generation
        servicer.seed_task_start_times(
            list(dispatcher.doing_start_times())
        )
        if stats.get("resize"):
            # A master crash mid-resize: re-offer the journaled
            # pending directive (acks are volatile; workers that
            # applied it already re-ack idempotently).
            servicer.rearm_resize(stats["resize"])


def recover_master_state(journal: "MasterJournal", dispatcher,
                         servicer=None,
                         metrics_registry=None,
                         eval_service=None,
                         fence: bool = False) -> Dict:
    """The full master-side recovery sequence: replay the journal into
    the dispatcher, re-arm the servicer (model version high-water mark
    + fresh straggler clocks for surviving leases) and the evaluation
    service (open round restored, raw outputs re-folded), bump the
    generation fence, re-attach the journal for write-through, and
    publish recovery telemetry. Returns the replay stats dict with
    ``recovery_seconds`` added.

    ``fence=True`` (standby takeover) publishes the fence file BEFORE
    opening the new generation, so a still-running prior incarnation
    is locked out of the journal from this point on — the split-brain
    guarantee. A plain restart (the old process is dead) skips it.

    Shared by ``master/main.py`` (process restart), the hot standby
    (``master/standby.py``), and the chaos restart seam
    (``testing/cluster.MiniCluster.restart_master``) so drills
    exercise the same code path production uses.
    """
    import time

    from elasticdl_tpu_torch.observability import default_registry, tracing

    registry = metrics_registry or default_registry()
    t0 = time.monotonic()
    with tracing.Tracer("master").span("recover") as sp:
        carry = apply_replay(dispatcher, journal.replay_records())
        if fence:
            journal.publish_fence(carry["generation"] + 1)
            # Drain records that raced in between the read above and
            # the fence landing (a live zombie may have appended) —
            # durable records the promoted state must not omit. After
            # the fence nothing more can land (same drain the
            # StandbyMaster takeover does).
            apply_replay(dispatcher, journal.replay_records(), carry)
        stats = carry
        stats["known_workers"] = sorted(stats["known_workers"])
        generation = journal.open_generation()
        if fence:
            journal.append("fence", generation=generation)
        rearm_recovered_master(journal, dispatcher, stats,
                               servicer=servicer,
                               eval_service=eval_service)
        sp.set(replayed=int(stats["replayed"]),
               generation=int(generation))
    elapsed = time.monotonic() - t0
    stats["generation"] = generation
    stats["recovery_seconds"] = elapsed
    registry.histogram(
        "master_recovery_seconds",
        "Journal replay + re-arm latency on master restart",
    ).observe(elapsed)
    registry.counter(
        "master_journal_replayed_records_total",
        "Journal records replayed into recovered dispatchers",
    ).inc(stats["replayed"])
    logger.info(
        "master recovered from %s: %d record(s) replayed "
        "(snapshot=%s) in %.4f s, generation %d, %d leased task(s) "
        "surviving", journal.path, stats["replayed"], stats["snapshot"],
        elapsed, generation, len(dispatcher.doing_start_times()),
    )
    return stats
