"""Fault plans (port of elasticdl_tpu/chaos/faults.py, a jax-free
copy): seed-deterministic schedules of injectable failures.

The paper's resilience claim — elasticity from task re-queuing and pod
relaunch, not checkpoint-restart — is only testable under *repeatable*
adversarial schedules (AMPS and the MPMD pipeline schedulers in
PAPERS.md both validate against scripted fault injection). A
``FaultPlan`` is that schedule: a list of ``FaultEvent``s whose
triggers are **call counts and save counts, never wall-clock**, so the
same plan against the same job replays the exact same fault sequence
(``chaos run --seed N`` twice is byte-identical). Randomized soak
plans are generated from a seed for the same reason: a soak failure
reproduces from the printed seed alone.

Event kinds:

- ``kill_worker``    — simulate pod death (SIGKILL / exit 137) at a
                       worker's Nth ``get_task``; recovery is the
                       dispatcher re-queue + relaunch-with-new-id path.
- ``rpc_drop``       — fail a named RPC with a transport code
                       (UNAVAILABLE by default); exercises the stub's
                       jittered-backoff retry.
- ``rpc_error``      — fail a named RPC with a *permanent* code
                       (INTERNAL): must surface, never retry.
- ``rpc_delay``      — add latency to a named RPC.
- ``stall_shard``    — server-side stall of one row-service shard's
                       handlers (the slow-PS regime).
- ``blackhole``      — drop every matching call for a window of
                       ``duration_calls`` calls (a dead channel).
- ``corrupt_checkpoint`` — truncate/garbage/delete a shard file of the
                       version written by the Nth matching save.
- ``master_kill``    — simulate MASTER pod death at the Nth dispatch
                       RPC: the harness's restart seam
                       rebuilds the master from its write-ahead
                       journal (master/journal.py) while the worker
                       rides the outage out on its RPC retry budget
                       and re-attaches under the bumped generation.
- ``fsync_stall``    — slow-disk brownout at a storage fsync seam:
                       ``target`` picks the seam —
                       ``"pushlog"`` stalls the WAL group commit that
                       durable-ack pushes wait on, ``"checkpoint"``
                       stalls the saver's shard-file fsyncs, ``""``
                       stalls both. The overload plane's deadline-
                       bounded durable waits are what keeps this from
                       wedging the push path.
"""

import dataclasses
import json
import random
from typing import Dict, List, Optional

KILL_WORKER = "kill_worker"
RPC_DROP = "rpc_drop"
RPC_ERROR = "rpc_error"
RPC_DELAY = "rpc_delay"
STALL_SHARD = "stall_shard"
BLACKHOLE = "blackhole"
CORRUPT_CHECKPOINT = "corrupt_checkpoint"
MASTER_KILL = "master_kill"
FSYNC_STALL = "fsync_stall"

KINDS = (
    KILL_WORKER, RPC_DROP, RPC_ERROR, RPC_DELAY, STALL_SHARD,
    BLACKHOLE, CORRUPT_CHECKPOINT, MASTER_KILL, FSYNC_STALL,
)

# Storage seams an fsync_stall can target ("" = every seam).
FSYNC_SEAMS = ("pushlog", "checkpoint")

# Site of an RPC fault: client = before the request leaves the stub
# (exercises stub retry/backoff), server = inside the handler wrap
# (exercises the caller's timeout/ride-out behavior).
SITES = ("client", "server")


@dataclasses.dataclass
class FaultEvent:
    """One scripted failure. Trigger semantics:

    - ``at_call`` (1-based): fire on the Nth call matching this
      event's (site, target, method) filter; with ``duration_calls``
      > 1 the event stays active for that many matching calls (a
      window). ``at_call=0`` means probabilistic: each matching call
      fires with ``probability`` drawn from the event's own seeded
      RNG — still replay-deterministic for a sequential caller.
    - ``max_fires`` caps total fires (0 = unlimited).
    - ``corrupt_checkpoint`` triggers on ``at_save``: the Nth save
      whose checkpoint dir contains ``target`` as a substring.
    """

    kind: str
    target: str = ""        # service name / server tag / ckpt-dir substring
    method: str = ""        # RPC method ("" = any)
    site: str = "client"    # where RPC faults inject (client|server)
    worker_id: int = -1     # kill victim (-1 = whichever worker matches)
    at_call: int = 0        # Nth matching call (1-based); 0 = probabilistic
    probability: float = 0.0
    delay_secs: float = 0.0
    duration_calls: int = 1  # window width for stall/blackhole
    code: str = "UNAVAILABLE"  # injected status code for drop/blackhole
    at_save: int = 0        # corrupt_checkpoint: Nth matching save
    corrupt_mode: str = "truncate"  # truncate | garbage | delete
    shard: int = 0          # stall_shard: which row-service shard
    max_fires: int = 1      # 0 = unlimited

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        # A hand-written window event (blackhole/stall over N calls)
        # must not be silently neutered by the max_fires=1 default:
        # the window IS the intended fire count.
        if (self.at_call > 0 and self.duration_calls > 1
                and self.max_fires
                and self.max_fires < self.duration_calls):
            self.max_fires = self.duration_calls
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.corrupt_mode not in ("truncate", "garbage", "delete"):
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}")
        if self.kind == FSYNC_STALL and self.target not in (
            ("",) + FSYNC_SEAMS
        ):
            raise ValueError(
                f"fsync_stall target must be one of {FSYNC_SEAMS} "
                f"(or '' for any), got {self.target!r}"
            )
        if self.at_call == 0 and self.kind in (
            RPC_DROP, RPC_ERROR, RPC_DELAY
        ) and not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultEvent fields {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class FaultPlan:
    """An ordered event list + the seed that (re)generates any
    probabilistic decisions. Serializes to stable JSON (sorted keys)
    so two runs of the same seed write byte-identical schedules."""

    events: List[FaultEvent] = dataclasses.field(default_factory=list)
    seed: int = 0

    def to_dict(self) -> dict:
        return {
            "seed": int(self.seed),
            "events": [e.to_dict() for e in self.events],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=2) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            events=[FaultEvent.from_dict(e) for e in d.get("events", [])],
            seed=int(d.get("seed", 0)),
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str):
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as fh:
            return cls.from_json(fh.read())


def default_plan(seed: int = 0,
                 master_service: str = "elasticdl_tpu.Master",
                 num_row_service_shards: int = 1) -> FaultPlan:
    """The canonical acceptance schedule: one worker kill,
    one row-shard stall window, one checkpoint corruption, and one
    transient RPC drop to exercise the stub retry — all positioned so
    recovery restores the newest *valid* checkpoint and the faulted
    run stays loss-equivalent to its fault-free twin at equal data
    order. Trigger positions wobble with the seed (same seed, same
    plan, byte for byte)."""
    rng = random.Random(int(seed))
    kill_call = 3 + rng.randint(0, 1)  # after 2-3 completed tasks
    events = [
        # Transient blip on the control plane: the stub's backoff retry
        # must ride it out with no schedule change.
        FaultEvent(
            kind=RPC_DROP, site="client", target=master_service,
            method="get_task", at_call=2, code="UNAVAILABLE",
        ),
        # Slow-shard regime: the worker's pulls/pushes just get slower,
        # nothing times out, order is unchanged.
        FaultEvent(
            kind=STALL_SHARD, site="server",
            shard=rng.randrange(max(1, num_row_service_shards)),
            at_call=4 + rng.randint(0, 2), duration_calls=3,
            delay_secs=0.05, max_fires=3,
        ),
        # Corrupt the FIRST worker-state checkpoint: later saves
        # supersede it, so recovery restores the newest valid version
        # and no completed task's training is lost (the corrupt-latest
        # case is the loss-equivalence checker's job to catch — see
        # tests/test_torch_chaos.py).
        FaultEvent(
            kind=CORRUPT_CHECKPOINT, target="state", at_save=1,
            corrupt_mode="truncate",
        ),
        # Hard pod death at a task boundary; recovery = re-queue +
        # relaunch under a new worker id + restore from checkpoint.
        FaultEvent(
            kind=KILL_WORKER, site="client", target=master_service,
            method="get_task", at_call=kill_call,
        ),
    ]
    return FaultPlan(events=events, seed=int(seed))


def master_kill_plan(seed: int = 0,
                     master_service: str = "elasticdl_tpu.Master",
                     num_row_service_shards: int = 1) -> FaultPlan:
    """The master-crash acceptance schedule: kill the master
    twice — once at a clean task boundary (a ``get_task``, nothing
    leased by the reporting path) and once mid-lease (the worker's
    ``report_task_result`` arrives at a master that just lost its
    memory) — plus one transient RPC drop so the ordinary stub-retry
    path is exercised alongside the restart ride-out. Both kills must
    leave accounting exactly-once and the loss trajectory equal to the
    fault-free twin: the first proves the journal replays the queue
    state, the second proves a surviving lease + retried report
    resolves without re-training. Trigger positions wobble with the
    seed (same seed, same plan, byte for byte)."""
    rng = random.Random(int(seed))
    # Trigger positions assume the canonical job shape (>= 4 tasks:
    # the default 64 records at 8x2 records/task). Kills are listed
    # BEFORE the drop so their call counters see every attempt — an
    # event only stops counting the call on which an earlier-listed
    # event fired.
    events = [
        # Kill #1: at a dispatch boundary — the recovered master must
        # hand out the exact task the dead one would have.
        FaultEvent(
            kind=MASTER_KILL, site="client", target=master_service,
            method="get_task", at_call=3 + rng.randint(0, 1),
        ),
        # Kill #2: mid-lease — the worker trained the task, the report
        # hits the fresh incarnation, which must accept it against the
        # replayed lease (NOT re-queue it: re-training would diverge
        # from the twin).
        FaultEvent(
            kind=MASTER_KILL, site="client", target=master_service,
            method="report_task_result", at_call=3 + rng.randint(0, 1),
        ),
        # Transient blip alongside the restarts: the plain stub-retry
        # path must coexist with generation fencing.
        FaultEvent(
            kind=RPC_DROP, site="client", target=master_service,
            method="get_task", at_call=2, code="UNAVAILABLE",
        ),
    ]
    return FaultPlan(events=events, seed=int(seed))


def randomized_plan(seed: int,
                    master_service: str = "elasticdl_tpu.Master",
                    num_row_service_shards: int = 1,
                    max_kills: int = 2) -> FaultPlan:
    """Soak-mode generator: a survivable random schedule fully
    determined by ``seed`` (print the seed, replay the failure)."""
    rng = random.Random(int(seed))
    events: List[FaultEvent] = []
    for _ in range(rng.randint(1, max_kills)):
        events.append(FaultEvent(
            kind=KILL_WORKER, site="client", target=master_service,
            method="get_task", at_call=rng.randint(2, 6),
        ))
    if rng.random() < 0.8:
        events.append(FaultEvent(
            kind=RPC_DROP, site="client", target=master_service,
            method=rng.choice(["get_task", "report_task_result"]),
            at_call=0, probability=rng.uniform(0.02, 0.15),
            max_fires=rng.randint(1, 3),
        ))
    if rng.random() < 0.6:
        events.append(FaultEvent(
            kind=STALL_SHARD, site="server",
            shard=rng.randrange(max(1, num_row_service_shards)),
            at_call=rng.randint(2, 8),
            duration_calls=rng.randint(1, 4),
            delay_secs=rng.uniform(0.01, 0.1),
            max_fires=rng.randint(1, 4),
        ))
    if rng.random() < 0.5:
        events.append(FaultEvent(
            kind=CORRUPT_CHECKPOINT, target="state",
            at_save=1,  # never the latest-at-kill version: soak plans
            # must stay loss-equivalent (see default_plan rationale)
            corrupt_mode=rng.choice(["truncate", "garbage", "delete"]),
        ))
    if rng.random() < 0.4:
        events.append(FaultEvent(
            kind=BLACKHOLE, site="client", target=master_service,
            method="report_version", at_call=rng.randint(2, 6),
            duration_calls=rng.randint(1, 3), max_fires=3,
        ))
    return FaultPlan(events=events, seed=int(seed))


def describe(plan: FaultPlan) -> str:
    """One line per event, for logs and the soak console."""
    lines = []
    for i, e in enumerate(plan.events):
        bits = [f"[{i}] {e.kind}"]
        if e.kind == KILL_WORKER:
            bits.append(f"victim={'any' if e.worker_id < 0 else e.worker_id}"
                        f" at get_task #{e.at_call}")
        elif e.kind == MASTER_KILL:
            bits.append(
                f"at {e.method or 'get_task'} #{e.at_call} "
                "(journal-replay restart)"
            )
        elif e.kind == CORRUPT_CHECKPOINT:
            bits.append(f"dir~{e.target!r} save #{e.at_save}"
                        f" mode={e.corrupt_mode}")
        elif e.kind == STALL_SHARD:
            bits.append(f"shard={e.shard} +{e.delay_secs}s"
                        f" x{e.duration_calls} from call #{e.at_call}")
        elif e.kind == FSYNC_STALL:
            bits.append(f"seam={e.target or 'any'} +{e.delay_secs}s"
                        f" x{e.duration_calls} from call #{e.at_call}")
        else:
            trig = (f"call #{e.at_call}" if e.at_call
                    else f"p={e.probability}")
            bits.append(f"{e.site} {e.target}/{e.method or '*'} {trig}"
                        f" code={e.code}")
        lines.append(" ".join(bits))
    return "\n".join(lines)
