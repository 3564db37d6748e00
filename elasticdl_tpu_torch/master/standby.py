"""Hot-standby master: warm failover in under a second.

A copy of elasticdl_tpu/master/standby.py: the port keeps its own. A
port standby tails a journal that either package's primary writes.

Before this module, a master death meant restart-and-replay: wait for
the pod to reschedule, pay a cold process start, replay the journal,
and only then serve again — seconds to minutes of control-plane
outage that docs/fault_tolerance.md could only size
``--master_reattach_grace`` around. ``StandbyMaster`` turns that into
a warm failover, the resource-orchestration shape of Podracer
(arxiv 2104.06272):

- **Continuous replay.** The standby tails the primary's journal
  (``MasterJournal`` read paths — the same file, on shared storage)
  and keeps a WARM dispatcher: each poll applies only the records
  appended since the last one (``journal.apply_replay`` with a carry;
  a compaction snapshot with a newer seq supersedes wholesale, so
  rewrites are transparent). Takeover pays the un-replayed *tail*,
  not the journal. ``master_standby_lag_records`` gauges how far
  behind the warm state runs.
- **Heartbeats.** A ``ping`` to the primary every
  ``heartbeat_secs``; ``miss_threshold`` consecutive failures
  (channel rebuilt between attempts — a refused gRPC channel can
  wedge) declare the primary dead. Successful beats observe
  ``master_primary_heartbeat_seconds``, which the default SLO ruleset
  watches with an absence rule: a standby that stops confirming
  heartbeats means the job's failover protection is gone.
- **Fencing, then takeover.** Promotion publishes the journal fence
  (``fence = last seen generation + 1``) *before* opening its own
  generation: from that instant a zombie primary — alive but
  partitioned — cannot land another journal byte (the append path
  re-checks the fence under an flock) and its RPC handlers answer
  ``stale_master``, so split-brain is structurally impossible. Then
  the warm dispatcher is re-armed through the same
  ``rearm_recovered_master`` sequence cold recovery uses (eval round
  restored, straggler clocks seeded, pending resize re-offered) and
  the RPC server binds the advertised address. Workers and
  row-services re-attach through their existing reconnect retry
  (``MasterClient`` rotates through its address list).
  ``master_failover_seconds`` observes detection→serving.

The drill that proves it: ``chaos/failover_drill.py`` (``python -m
elasticdl_tpu_torch.chaos.failover_drill run --workdir D``) SIGKILLs
real primary processes mid-lease, mid-eval-round, and
mid-resize-barrier, and gates takeover downtime at ≥5x better than
restart-and-replay on the same kill schedule.
"""

import threading
import time
from typing import Callable, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.master.journal import (
    JournalFormatError,
    MasterJournal,
    apply_replay,
    new_replay_carry,
    rearm_recovered_master,
)
from elasticdl_tpu_torch.master.servicer import SERVICE_NAME

logger = get_logger("master_standby")


class StandbyMaster:
    """One warm standby for one journaled master.

    ``dispatcher_factory()`` must build a dispatcher from the
    IDENTICAL job config the primary used (shards, sizing, seed) —
    same contract as every journal-recovery path. ``assemble(
    dispatcher, journal)`` returns ``(evaluation_service, servicer)``
    wired around them (called at promotion, AFTER the new generation
    is open, so the servicer may stamp it; the journal must not be
    attached to the eval service — promotion attaches it after the
    restore). ``serve_addr`` is the address the promoted master binds
    (the advertised address workers re-resolve to).
    """

    def __init__(
        self,
        journal_dir: str,
        dispatcher_factory: Callable,
        assemble: Callable,
        primary_addr: str,
        serve_addr: str,
        heartbeat_secs: float = 1.0,
        miss_threshold: int = 3,
        poll_secs: float = 0.5,
        bind_retries: int = 40,
        bind_retry_secs: float = 0.25,
        metrics_registry=None,
        on_promoted: Optional[Callable] = None,
        handlers_factory: Optional[Callable] = None,
    ):
        from elasticdl_tpu_torch.observability import default_registry

        self._journal = MasterJournal(journal_dir)
        self._dispatcher_factory = dispatcher_factory
        self._assemble = assemble
        self._primary_addr = primary_addr
        self._serve_addr = serve_addr
        self._heartbeat_secs = max(0.01, float(heartbeat_secs))
        self._miss_threshold = max(1, int(miss_threshold))
        self._poll_secs = max(0.01, float(poll_secs))
        self._bind_retries = int(bind_retries)
        self._bind_retry_secs = float(bind_retry_secs)
        self._on_promoted = on_promoted
        # fn(servicer) -> handler dict for the promoted server;
        # defaults to servicer.handlers(). Lets embedders (the
        # failover drill's control-plane stand-in) add aux methods.
        self._handlers_factory = handlers_factory
        self._stop = threading.Event()
        self._stub = None
        self._misses = 0
        # Warm state: a journal-replayed dispatcher plus the carry
        # that lets the next poll apply only fresh records.
        self._dispatcher = dispatcher_factory()
        self._carry = new_replay_carry()
        # (size, mtime_ns) of the journal at the last poll: an
        # unchanged file skips the read entirely, so idle polls cost
        # one stat — not a full decode of snapshot + eval folds.
        self._last_stat = None
        # Incremental read cursor: byte offset of the first unread
        # frame, plus the head frame's (seq, type) — a changed head
        # means compaction rewrote the file and the cursor resets.
        # Active-job polls therefore decode only the appended TAIL,
        # matching the "pays the tail, not the journal" design on the
        # read side too (the seq gate in apply_replay makes any
        # fallback full re-read double-apply-free).
        self._read_cursor = 0
        self._head_sig = None
        # Promoted artifacts (None until takeover).
        self.promoted = False
        self.server = None
        self.servicer = None
        self.eval_service = None
        self.dispatcher = None
        self.generation = -1
        self.takeover_stats: Optional[dict] = None

        registry = metrics_registry or default_registry()
        self._m_lag = registry.gauge(
            "master_standby_lag_records",
            "Journal records the standby's warm replay is behind "
            "(sampled at each poll, before catching up)",
        )
        self._m_replayed = registry.counter(
            "master_standby_replayed_records_total",
            "Journal records folded into the standby's warm state",
        )
        self._m_heartbeat = registry.histogram(
            "master_primary_heartbeat_seconds",
            "Primary heartbeat round-trip observed by the standby "
            "(the default SLO ruleset alerts on its ABSENCE: no "
            "beats = failover protection is gone)",
        )
        self._m_failover = registry.histogram(
            "master_failover_seconds",
            "Hot-standby takeover latency: primary declared dead -> "
            "new incarnation serving on the advertised address",
        )

    # ---- journal tailing (continuous replay) ---------------------------

    def poll_journal(self) -> int:
        """Fold any newly-appended records into the warm dispatcher;
        returns how many records were applied. Divergence or mid-file
        corruption rebuilds the warm state from scratch (the cold
        path) rather than serving wrong state later."""
        import os

        try:
            st = os.stat(self._journal.path)
            sig = (st.st_size, st.st_mtime_ns)
        except OSError:
            return 0  # journal not created yet
        if sig == self._last_stat:
            return 0  # nothing appended (and compaction moves mtime)
        try:
            head = self._journal.head_signature()
            if head != self._head_sig or st.st_size < self._read_cursor:
                # Compaction rewrote the file (or first poll): the
                # cursor's boundary is meaningless — read from the top.
                self._head_sig = head
                self._read_cursor = 0
            records = []
            cursor = self._read_cursor
            from elasticdl_tpu_torch.master.journal import (
                read_records,
                validate_record,
            )

            for _offset, end, record in read_records(
                self._journal.path, start=self._read_cursor
            ):
                err = validate_record(record)
                if err:
                    raise JournalFormatError(err)
                records.append(record)
                cursor = end
        except JournalFormatError:
            logger.exception("journal unreadable; will re-poll")
            return 0
        # Committed only after a successful read: records appended
        # between the stat and the read re-read next poll (seq-gated,
        # so re-reads are free of double-apply).
        self._last_stat = sig
        self._read_cursor = cursor
        if not records:
            return 0
        behind = sum(
            1 for r in records
            if int(r.get("seq", 0)) > self._carry["seq"]
        )
        self._m_lag.set(float(behind))
        if not behind:
            return 0
        before = self._carry["replayed"]
        try:
            apply_replay(self._dispatcher, records, self._carry)
        except JournalFormatError:
            # The warm state machine disagreed with the tail (e.g. a
            # primary restart replayed differently than our increment
            # assumed). Cold rebuild from the FULL journal (the
            # incremental read above held only the tail) —
            # correctness over warmth.
            logger.exception(
                "incremental replay diverged; rebuilding warm state"
            )
            self._dispatcher = self._dispatcher_factory()
            self._carry = new_replay_carry()
            apply_replay(
                self._dispatcher, self._journal.replay_records(),
                self._carry,
            )
            before = 0
        applied = self._carry["replayed"] - before
        self._m_replayed.inc(max(0, applied))
        self._m_lag.set(0.0)
        return applied

    # ---- heartbeating ---------------------------------------------------

    def heartbeat(self) -> bool:
        """One ping to the primary; True = alive. Rebuilds the channel
        on failure (a channel refused for a while can wedge)."""
        from elasticdl_tpu_torch.comm.rpc import RpcStub

        if self._stub is None:
            self._stub = RpcStub(
                self._primary_addr, SERVICE_NAME, max_retries=0
            )
        t0 = time.monotonic()
        try:
            self._stub.call(
                "ping", timeout=max(0.5, self._heartbeat_secs)
            )
        except Exception:
            self._misses += 1
            logger.warning(
                "primary heartbeat missed (%d/%d)",
                self._misses, self._miss_threshold,
            )
            try:
                self._stub.reconnect()
            except Exception:
                self._stub = None
            return False
        self._m_heartbeat.observe(time.monotonic() - t0)
        self._misses = 0
        return True

    # ---- takeover --------------------------------------------------------

    def _fence_and_drain(self) -> int:
        """The shared front half of every takeover: catch the tail,
        publish the fence (zombie locked out), then drain records
        that won the race against the fence publish (seq-gated, so
        the drain cannot double-apply). ONE copy of this ordering —
        ``take_over`` (embedded: assembles + serves) and
        ``hand_over`` (CLI: feeds ``Master(warm_state=…)``) must not
        drift on it."""
        self.poll_journal()
        fence_gen = self._journal.publish_fence(
            self._carry["generation"] + 1
        )
        self.poll_journal()
        return fence_gen

    def hand_over(self) -> dict:
        """The NON-serving half of a takeover: fence + drain, then
        release the journal — returning ``{"dispatcher", "stats",
        "fence_generation"}`` for a caller that finishes promotion
        itself (``master/main.py run_standby`` feeds this straight
        into ``Master(warm_state=…)``, which opens the post-fence
        generation and re-arms the full production assembly)."""
        fence_gen = self._fence_and_drain()
        self._journal.close()
        return {
            "dispatcher": self._dispatcher,
            "stats": dict(self._carry),
            "fence_generation": fence_gen,
        }

    def take_over(self) -> dict:
        """Fence the old incarnation and start serving. Sequence:
        catch the tail → publish the fence (zombie locked out) → catch
        anything that raced in before the fence landed → open our
        generation (+ fence record) → re-arm the warm dispatcher →
        bind the advertised address."""
        from elasticdl_tpu_torch.comm.rpc import RpcServer

        t_detect = time.monotonic()
        phases = {}

        def _mark(name, t0):
            now = time.monotonic()
            phases[name] = round(now - t0, 4)
            return now

        t = t_detect
        fence_gen = self._fence_and_drain()
        t = _mark("fence", t)
        self.generation = self._journal.open_generation()
        self._journal.append("fence", generation=self.generation)
        t = _mark("open_generation", t)
        stats = dict(self._carry)
        stats["known_workers"] = sorted(stats["known_workers"])
        self.dispatcher = self._dispatcher
        self.eval_service, self.servicer = self._assemble(
            self.dispatcher, self._journal
        )
        rearm_recovered_master(
            self._journal, self.dispatcher, stats,
            servicer=self.servicer, eval_service=self.eval_service,
        )
        t = _mark("assemble_rearm", t)
        # The old incarnation's socket may linger in TIME_WAIT /
        # teardown for a beat — retry the bind like the drill fleets
        # retry shard relaunch ports.
        handlers = (
            self._handlers_factory(self.servicer)
            if self._handlers_factory is not None
            else self.servicer.handlers()
        )
        last_exc = None
        for _ in range(max(1, self._bind_retries)):
            try:
                self.server = RpcServer(
                    self._serve_addr,
                    {SERVICE_NAME: handlers},
                ).start()
                break
            except Exception as exc:
                last_exc = exc
                time.sleep(self._bind_retry_secs)
        if self.server is None:
            raise RuntimeError(
                f"standby could not bind {self._serve_addr}: "
                f"{last_exc}"
            )
        _mark("bind", t)
        elapsed = time.monotonic() - t_detect
        self._m_failover.observe(elapsed)
        self.promoted = True
        stats["generation"] = self.generation
        stats["fence_generation"] = fence_gen
        stats["takeover_seconds"] = elapsed
        stats["takeover_phases"] = phases
        self.takeover_stats = stats
        logger.warning(
            "STANDBY PROMOTED: generation %d (fence %d) serving on "
            "%s after %.3fs (%s); %d record(s) warm-replayed, %d "
            "leased task(s) surviving",
            self.generation, fence_gen, self._serve_addr, elapsed,
            phases, stats["replayed"],
            len(self.dispatcher.doing_start_times()),
        )
        if self._on_promoted is not None:
            self._on_promoted(self)
        return stats

    # ---- the standby loop ------------------------------------------------

    def run(self) -> bool:
        """Tail + heartbeat until the primary dies (→ take_over,
        returns True) or ``stop()`` is called (returns False)."""
        next_poll = 0.0
        next_beat = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_poll:
                self.poll_journal()
                next_poll = now + self._poll_secs
            if now >= next_beat:
                self.heartbeat()
                next_beat = now + self._heartbeat_secs
                if self._misses >= self._miss_threshold:
                    self.take_over()
                    return True
            self._stop.wait(
                max(0.005, min(next_poll, next_beat) - time.monotonic())
            )
        return False

    def start(self) -> threading.Thread:
        thread = threading.Thread(
            target=self.run, daemon=True, name="master-standby"
        )
        thread.start()
        return thread

    def stop(self):
        self._stop.set()
        if self._stub is not None:
            try:
                self._stub.close()
            except Exception:
                pass

    def close(self):
        self.stop()
        if self.server is not None:
            self.server.stop(0)
        self._journal.close()
