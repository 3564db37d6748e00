"""Continuous profiling plane: always-on sampling profiler + master
profile store.

The metrics plane says *how much*, the trace plane says *which phase*;
this module says *which code*. A ``SamplingProfiler`` walks
``sys._current_frames()`` on a daemon thread (default ~67 Hz — a prime
rate, so it can't alias against 10/50/100 Hz periodic work), folds each
thread's Python stack into a **bounded flame table** keyed
``<thread-class>;<frame>;<frame>;...`` (root first, leaf last — the
standard folded-flamegraph form), and closes a window every
``window_secs`` into a ring with a monotonic ``seq`` — the exact shape
the tracing plane uses, so windows ride the same piggyback path
(worker snapshot ``profiles`` key, ``ComponentMetricsReporter``) into
the master's ``ProfileStore`` and serve on ``/profile`` next to
``/metrics``.

Cost discipline (the PR 4 span lesson, enforced by
tests/test_profile_plane.py): one sample is a GIL-held dict walk with
frame names cached per code object — tens of microseconds — so at the
default rate the profiler costs well under 1% of a busy worker loop
(``overhead_fraction`` measures it; the drill and the fast-lane pin
both gate on ≤ 1%). The flame table is bounded (``max_stacks``): under
pathological stack churn new distinct stacks collapse into
``OVERFLOW_KEY`` instead of growing without bound.

Device/phase attribution: ``fold_spans`` folds collected trace spans
(MeshRunner step phases, host-engine pulls, rpc handlers) into the
same folded format under a ``phases`` pseudo-thread-class, weighted by
self-time × hz — so host stacks and device phases render in one flame
view on ``/profile`` (docs/observability.md "Continuous profiling &
exemplars").

Differential profiles: ``ProfileStore.render(... base_secs=N)``
compares the current window against the same-length window ending N
seconds earlier — the before/after-resize regression view.
"""

import re
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("profiler")

DEFAULT_HZ = 67.0
DEFAULT_WINDOW_SECS = 10.0
DEFAULT_MAX_STACKS = 512
DEFAULT_MAX_WINDOWS = 64
MAX_DEPTH = 48
OVERFLOW_KEY = "__overflow__"
# Pseudo thread-class for span-derived (device/phase) samples — never
# produced by the sampler, excluded from the per-class sample-count
# consistency check in tools/check_profile.py.
SPAN_CLASS = "phases"

# ---- process-global profiler seam (None = profiling off) ----------------

_PROFILER: Optional["SamplingProfiler"] = None


def install_profiler(prof: "SamplingProfiler") -> "SamplingProfiler":
    """Install (or replace) the process profiler. Does not start it —
    callers start() explicitly (tests drive sample() by hand)."""
    global _PROFILER
    if _PROFILER is not None and _PROFILER is not prof:
        _PROFILER.stop()
    _PROFILER = prof
    return prof


def uninstall_profiler():
    global _PROFILER
    if _PROFILER is not None:
        _PROFILER.stop()
    _PROFILER = None


def profiler() -> Optional["SamplingProfiler"]:
    return _PROFILER


def windows_since(cursor: int) -> Tuple[List[dict], int]:
    """Closed windows with seq > cursor plus the new cursor — the
    piggyback reporters' incremental read. ([], cursor) when off."""
    prof = _PROFILER
    if prof is None:
        return [], cursor
    return prof.windows_since(cursor)


def maybe_start_from_args(args, role: str,
                          instance: str = "0"
                          ) -> Optional["SamplingProfiler"]:
    """Install + start a profiler when the process main was given
    ``--profile_hz > 0``; the standard gate every component main uses
    (master / worker / row-service / router / serving)."""
    hz = float(getattr(args, "profile_hz", 0.0) or 0.0)
    if hz <= 0:
        return None
    prof = SamplingProfiler(
        hz=hz,
        window_secs=float(
            getattr(args, "profile_window_secs", DEFAULT_WINDOW_SECS)
            or DEFAULT_WINDOW_SECS
        ),
        role=role,
        instance=str(instance),
    )
    install_profiler(prof)
    prof.start()
    logger.info(
        "sampling profiler on: %.0f Hz, %.0fs windows (role %s/%s)",
        hz, prof.window_secs, role, instance,
    )
    return prof


def thread_class(name: str) -> str:
    """Collapse thread names into a bounded class set: pool workers
    (grpc handlers run on ``ThreadPoolExecutor-N_M`` threads) fold
    together, numbered clones of named daemons fold with their base
    name."""
    if name == "MainThread":
        return "main"
    if name.startswith(("ThreadPoolExecutor", "Dummy-")):
        return "pool"
    # "Thread-3 (worker_fn)" (the 3.10+ default) → "thread".
    name = re.sub(r"\s*\(.*\)$", "", name)
    base = re.sub(r"[-_ ]?[0-9]+(_[0-9]+)?$", "", name)
    return (base or "thread").lower()


class SamplingProfiler:
    """Always-on wall-clock sampling profiler for one process.

    ``clock`` (wall time) is injectable so window-boundary tests are
    deterministic; the daemon loop paces itself on ``time.monotonic``
    regardless. ``sample()`` is public: tests drive it directly."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 window_secs: float = DEFAULT_WINDOW_SECS,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 max_windows: int = DEFAULT_MAX_WINDOWS,
                 role: str = "process", instance: str = "0",
                 clock: Callable[[], float] = time.time,
                 metrics_registry=None):
        if hz <= 0:
            raise ValueError("hz must be positive")
        self.hz = float(hz)
        self.window_secs = float(window_secs)
        self.max_stacks = int(max_stacks)
        self.role = str(role)
        self.instance = str(instance)
        self._clock = clock
        self._lock = threading.Lock()
        self._windows = deque(maxlen=int(max_windows))
        self._seq = 0
        self._samples: Dict[str, int] = {}
        self._window_t0: Optional[float] = None
        self._passes = 0
        self._thread_peaks: Dict[str, int] = {}
        self._dropped = 0
        # frame-name cache keyed by code object: the stack walk's cost
        # is dominated by string building; code objects are stable, so
        # after warm-up a sample is dict lookups only.
        self._names: Dict[object, str] = {}
        # thread-name map refreshed every _THREAD_REFRESH passes —
        # threading.enumerate() per sample would double the walk cost.
        self._thread_names: Dict[int, str] = {}
        self._thread_refresh_left = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._own_ident: Optional[int] = None
        # EWMA of one sample's wall cost — overhead_fraction() input.
        self.sample_cost_ewma = 0.0
        from elasticdl_tpu_torch.observability import default_registry

        registry = metrics_registry or default_registry()
        self._m_samples = registry.counter(
            "profile_samples_total",
            "Sampling-profiler stack-walk passes taken",
        )
        self._m_overflow = registry.counter(
            "profile_stack_overflow_total",
            "Samples folded into the overflow bucket because the "
            "flame table hit max_stacks",
        )

    _THREAD_REFRESH = 32

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="sampling-profiler"
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None

    def _run(self):
        self._own_ident = threading.get_ident()
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample()
            except Exception:
                # One bad walk (a frame dying mid-read) must not kill
                # the profiler for the rest of the process's life.
                logger.exception("profiler sample failed")

    # ---- sampling ------------------------------------------------------

    def _refresh_threads(self):
        self._thread_names = {
            t.ident: thread_class(t.name)
            for t in threading.enumerate()
            if t.ident is not None
        }
        self._thread_refresh_left = self._THREAD_REFRESH

    def _frame_label(self, frame) -> str:
        code = frame.f_code
        name = self._names.get(code)
        if name is None:
            mod = frame.f_globals.get("__name__", "") or ""
            qual = getattr(code, "co_qualname", code.co_name)
            name = f"{mod}.{qual}" if mod else str(qual)
            self._names[code] = name
        return name

    def sample(self, now: Optional[float] = None):
        """One stack-walk pass over every live thread (except the
        profiler's own); rolls the window first when it has aged out."""
        t_cost = time.perf_counter()
        now = self._clock() if now is None else now
        with self._lock:
            if self._window_t0 is None:
                self._window_t0 = now
            elif now - self._window_t0 >= self.window_secs:
                self._close_window_locked(now)
            if self._thread_refresh_left <= 0:
                self._refresh_threads()
            self._thread_refresh_left -= 1
            frames = sys._current_frames()
            own = self._own_ident
            per_class: Dict[str, int] = {}
            for ident, frame in frames.items():
                if ident == own:
                    continue
                tclass = self._thread_names.get(ident, "thread")
                per_class[tclass] = per_class.get(tclass, 0) + 1
                stack = []
                depth = 0
                while frame is not None and depth < MAX_DEPTH:
                    stack.append(self._frame_label(frame))
                    frame = frame.f_back
                    depth += 1
                truncated = frame is not None
                stack.reverse()
                if truncated:
                    stack.insert(0, "...")
                folded = tclass + ";" + ";".join(stack)
                if (folded not in self._samples
                        and len(self._samples) >= self.max_stacks):
                    folded = OVERFLOW_KEY
                    self._dropped += 1
                    self._m_overflow.inc()
                self._samples[folded] = self._samples.get(folded, 0) + 1
            for tclass, n in per_class.items():
                if n > self._thread_peaks.get(tclass, 0):
                    self._thread_peaks[tclass] = n
            self._passes += 1
        self._m_samples.inc()
        cost = time.perf_counter() - t_cost
        self.sample_cost_ewma = (
            cost if self.sample_cost_ewma == 0.0
            else 0.9 * self.sample_cost_ewma + 0.1 * cost
        )

    def _close_window_locked(self, now: float):
        if self._passes:
            self._seq += 1
            self._windows.append({
                "seq": self._seq,
                "t0": float(self._window_t0),
                "t1": float(now),
                "hz": self.hz,
                "role": self.role,
                "instance": self.instance,
                "sample_count": self._passes,
                "threads": dict(self._thread_peaks),
                "samples": dict(self._samples),
                "dropped": self._dropped,
            })
        self._window_t0 = now
        self._passes = 0
        self._samples = {}
        self._thread_peaks = {}
        self._dropped = 0

    def close_window(self, now: Optional[float] = None):
        """Force-close the open window (shutdown flush / tests)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._close_window_locked(now)

    # ---- reads ---------------------------------------------------------

    def windows_since(self, cursor: int) -> Tuple[List[dict], int]:
        with self._lock:
            return (
                [w for w in self._windows if w["seq"] > cursor],
                self._seq,
            )

    def snapshot_windows(self, include_open: bool = True) -> List[dict]:
        """All retained windows, plus (optionally) a copy of the open
        one — how a component's own ``/profile`` route stays fresh
        instead of lagging a full window."""
        with self._lock:
            out = list(self._windows)
            if include_open and self._passes:
                out.append({
                    "seq": None,
                    "t0": float(self._window_t0),
                    "t1": float(self._clock()),
                    "hz": self.hz,
                    "role": self.role,
                    "instance": self.instance,
                    "sample_count": self._passes,
                    "threads": dict(self._thread_peaks),
                    "samples": dict(self._samples),
                    "dropped": self._dropped,
                    "open": True,
                })
            return out

    def overhead_fraction(self) -> float:
        """Estimated fraction of one core the profiler consumes at its
        configured rate — the ≤1% pin's measurement."""
        return self.sample_cost_ewma * self.hz


# ---- folded / pprof rendering -------------------------------------------


def folded_text(samples: Dict[str, int]) -> str:
    """Standard folded-flamegraph text: ``frame;frame;frame count``
    per line, heaviest first (stable for goldens: count desc, then
    stack)."""
    lines = [
        f"{stack} {int(count)}"
        for stack, count in sorted(
            samples.items(), key=lambda kv: (-kv[1], kv[0])
        )
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def pprof_json(window: dict) -> dict:
    """pprof-shaped JSON for one (merged) window: a string table plus
    location-index sample stacks — loadable by anything that speaks
    the gzipped-proto profile.proto *shape* without the proto dep.
    ``tools/check_profile.py`` validates it."""
    samples = window.get("samples", {})
    strings: List[str] = []
    index: Dict[str, int] = {}

    def intern(s: str) -> int:
        at = index.get(s)
        if at is None:
            at = index[s] = len(strings)
            strings.append(s)
        return at

    hz = float(window.get("hz") or DEFAULT_HZ)
    out_samples = []
    for stack, count in sorted(
        samples.items(), key=lambda kv: (-kv[1], kv[0])
    ):
        frames = stack.split(";")
        out_samples.append({
            "location_id": [intern(f) for f in frames],
            # value[0] = sample count, value[1] = estimated seconds.
            "value": [int(count), round(count / hz, 6)],
        })
    return {
        "sample_type": [
            {"type": "samples", "unit": "count"},
            {"type": "wall", "unit": "seconds"},
        ],
        "period": 1.0 / hz,
        "duration_seconds": round(
            float(window.get("t1", 0.0)) - float(window.get("t0", 0.0)),
            6,
        ),
        "string_table": strings,
        "samples": out_samples,
    }


def merge_windows(windows: List[dict]) -> Optional[dict]:
    """Fold several windows into one (sample counts sum, bounds span,
    thread peaks max). None for an empty list."""
    if not windows:
        return None
    merged_samples: Dict[str, int] = {}
    threads: Dict[str, int] = {}
    passes = 0
    dropped = 0
    for w in windows:
        passes += int(w.get("sample_count", 0))
        dropped += int(w.get("dropped", 0))
        for stack, count in (w.get("samples") or {}).items():
            merged_samples[stack] = (
                merged_samples.get(stack, 0) + int(count)
            )
        for tclass, peak in (w.get("threads") or {}).items():
            if int(peak) > threads.get(tclass, 0):
                threads[tclass] = int(peak)
    last = windows[-1]
    return {
        "t0": min(float(w.get("t0", 0.0)) for w in windows),
        "t1": max(float(w.get("t1", 0.0)) for w in windows),
        "hz": float(last.get("hz") or DEFAULT_HZ),
        "role": last.get("role", "process"),
        "instance": last.get("instance", "0"),
        "sample_count": passes,
        "threads": threads,
        "samples": merged_samples,
        "dropped": dropped,
        "windows": len(windows),
    }


def diff_profiles(cur: dict, base: dict, top: int = 100) -> List[dict]:
    """Per-stack share deltas between two merged windows — the
    before/after-resize regression view. Shares (count / total), not
    raw counts, so windows of different lengths compare."""
    cur_samples = cur.get("samples") or {}
    base_samples = base.get("samples") or {}
    cur_total = sum(cur_samples.values()) or 1
    base_total = sum(base_samples.values()) or 1
    out = []
    for stack in set(cur_samples) | set(base_samples):
        c = cur_samples.get(stack, 0)
        b = base_samples.get(stack, 0)
        cf = c / cur_total
        bf = b / base_total
        out.append({
            "stack": stack,
            "cur": int(c),
            "base": int(b),
            "cur_frac": round(cf, 6),
            "base_frac": round(bf, 6),
            "delta_frac": round(cf - bf, 6),
        })
    out.sort(key=lambda d: (-abs(d["delta_frac"]), d["stack"]))
    return out[: int(top)]


# ---- span folding (device/phase attribution) ----------------------------


def fold_spans(spans: List[dict], hz: float,
               role: Optional[str] = None,
               instance: Optional[str] = None) -> Dict[str, int]:
    """Collected trace spans → folded pseudo-samples under the
    ``phases`` class, weighted by SELF time (duration minus child
    durations) × hz — so a MeshRunner ``device_step`` or a host-engine
    ``row_pull`` lands in the same flame view as the Python stacks
    that surround it. ``role``/``instance`` filter to one component's
    spans (None = all)."""
    by_id = {}
    child_dur: Dict[str, float] = {}
    for s in spans:
        if not isinstance(s, dict) or not s.get("span_id"):
            continue
        by_id[s["span_id"]] = s
    for s in by_id.values():
        parent = s.get("parent_id")
        if parent in by_id:
            child_dur[parent] = (
                child_dur.get(parent, 0.0) + float(s.get("dur", 0.0))
            )

    def path(span, depth=0) -> List[str]:
        if depth > MAX_DEPTH:
            return ["..."]
        parent = by_id.get(span.get("parent_id"))
        prefix = path(parent, depth + 1) if parent is not None else []
        return prefix + [str(span.get("name", "span"))]

    folded: Dict[str, int] = {}
    for s in by_id.values():
        if role is not None and s.get("role") != role:
            continue
        if instance is not None and str(
            s.get("instance", "0")
        ) != str(instance):
            continue
        self_secs = max(
            0.0,
            float(s.get("dur", 0.0)) - child_dur.get(s["span_id"], 0.0),
        )
        weight = int(round(self_secs * hz))
        if weight <= 0:
            continue
        key = ";".join(
            [SPAN_CLASS, f"{s.get('role', 'process')}/"
                         f"{s.get('instance', '0')}"] + path(s)
        )
        folded[key] = folded.get(key, 0) + weight
    return folded


# ---- component naming ---------------------------------------------------


def component_role(component: str) -> Tuple[str, str]:
    """Map a cluster-view reporter key to its trace (role, instance):
    ``""`` → master, bare ints → workers, ``rowservice-1`` /
    ``router-0`` / ``serving-2`` → themselves."""
    component = str(component)
    if component in ("", "master"):
        return "master", "0"
    try:
        return "worker", str(int(component))
    except ValueError:
        pass
    name, _, inst = component.rpartition("-")
    if name and inst.isdigit():
        return name, inst
    return component, "0"


# ---- master-side store --------------------------------------------------


class ProfileStore:
    """Piggybacked profile windows per reporter, bounded, deduped by
    (seq, t0) — several RPCs can offer the same un-acked window (the
    span-cursor discipline), and a restarted process's seq restarts.
    Source ``""`` is this process itself (``pull_local``)."""

    def __init__(self, max_windows_per_source: int = 360):
        self._lock = threading.Lock()
        self._max = int(max_windows_per_source)
        self._sources: Dict[str, deque] = {}
        self._local_cursor = 0
        # The local profiler's OPEN window, refreshed on every
        # pull_local and held OUTSIDE the ring: ingesting it would
        # double-count once the same window closes with a real seq
        # (and the (None, t0) dedup would freeze it at its first
        # snapshot). merged("") folds it in at read time instead.
        self._local_open: Optional[dict] = None

    def ingest(self, source, windows) -> int:
        if not windows:
            return 0
        source = str(source)
        added = 0
        with self._lock:
            ring = self._sources.get(source)
            if ring is None:
                ring = self._sources[source] = deque(maxlen=self._max)
            seen = {(w.get("seq"), w.get("t0")) for w in ring}
            for w in windows:
                if not isinstance(w, dict) or not w.get("samples"):
                    continue
                key = (w.get("seq"), w.get("t0"))
                if key in seen:
                    continue
                seen.add(key)
                ring.append(dict(w))
                added += 1
        return added

    def pull_local(self):
        """Fold this process's own profiler windows in under source
        ``""`` — the master's own profile must not depend on a
        piggyback loop it doesn't have. Closed windows enter the ring;
        the open window is held aside (refreshed every pull, merged at
        read time) so /profile on a freshly started process is not
        empty for a full window length."""
        windows, self._local_cursor = windows_since(self._local_cursor)
        if windows:
            self.ingest("", windows)
        prof = _PROFILER
        open_window = None
        if prof is not None:
            for w in prof.snapshot_windows(include_open=True):
                if w.get("open"):
                    open_window = w
        with self._lock:
            self._local_open = open_window

    def components(self) -> List[dict]:
        with self._lock:
            out = []
            for source, ring in sorted(self._sources.items()):
                if not ring:
                    continue
                last = ring[-1]
                out.append({
                    "component": source,
                    "role": last.get("role"),
                    "instance": last.get("instance"),
                    "windows": len(ring),
                    "t1": last.get("t1"),
                    "hz": last.get("hz"),
                })
            return out

    def drop_source(self, source: str):
        with self._lock:
            self._sources.pop(str(source), None)

    def merged(self, component: str, window_secs: float = 60.0,
               now: Optional[float] = None,
               end_offset_secs: float = 0.0) -> Optional[dict]:
        """Windows of ``component`` overlapping the ``window_secs``
        span ending ``end_offset_secs`` ago, merged. None = no data."""
        now = time.time() if now is None else now
        end = now - float(end_offset_secs)
        lo = end - float(window_secs)
        with self._lock:
            ring = self._sources.get(str(component), ())
            picked = [
                w for w in ring
                if float(w.get("t1", 0.0)) > lo
                and float(w.get("t0", 0.0)) < end
            ]
            if str(component) == "" and self._local_open is not None:
                o = self._local_open
                closed_t0s = {w.get("t0") for w in picked}
                # Skip once the same accumulation has closed into the
                # ring (same t0) — else its samples would count twice.
                if (o.get("t0") not in closed_t0s
                        and float(o.get("t1", 0.0)) > lo
                        and float(o.get("t0", 0.0)) < end):
                    picked = picked + [o]
        return merge_windows(picked) if picked else None

    def render(self, component: str, window_secs: float = 60.0,
               base_secs: Optional[float] = None,
               spans: Optional[List[dict]] = None,
               now: Optional[float] = None, top: int = 100) -> dict:
        """The ``/profile`` JSON body. With ``spans``, span-derived
        phase samples merge into the flame view under the ``phases``
        class; with ``base_secs``, a same-length window ending that
        many seconds earlier renders as a differential."""
        self.pull_local()
        component = str(component)
        now = time.time() if now is None else now
        window = self.merged(component, window_secs, now=now)
        if window is None:
            return {
                "component": component,
                "window_secs": window_secs,
                "error": f"no profile windows for {component!r}",
                "components": self.components(),
            }
        combined = dict(window["samples"])
        if spans:
            role, instance = component_role(component)
            for stack, count in fold_spans(
                spans, window["hz"], role=role, instance=instance
            ).items():
                combined[stack] = combined.get(stack, 0) + count
        window = dict(window)
        window["samples"] = combined
        out = {
            "component": component,
            "window_secs": float(window_secs),
            "window": window,
            "folded": folded_text(combined),
            "pprof": pprof_json(window),
        }
        if base_secs is not None:
            base = self.merged(
                component, window_secs, now=now,
                end_offset_secs=float(base_secs),
            )
            if base is not None:
                out["base"] = base
                out["diff"] = diff_profiles(window, base, top=top)
            else:
                out["base"] = None
                out["diff"] = []
        return out

    def bundle_capture(self, window_secs: float = 120.0,
                       now: Optional[float] = None) -> dict:
        """The incident bundle's ``profile.json`` payload: one merged
        window + folded text per component with recent data — the
        2 a.m. flame graph of every role at the moment the rule
        fired."""
        self.pull_local()
        now = time.time() if now is None else now
        components = {}
        with self._lock:
            names = [s for s, ring in self._sources.items() if ring]
        for name in names:
            window = self.merged(name, window_secs, now=now)
            if window is None:
                continue
            components[name] = {
                "window": window,
                "folded": folded_text(window["samples"]),
            }
        return {
            "window_secs": float(window_secs),
            "captured_at": now,
            "components": components,
        }


# ---- flame-table reductions (dump_metrics --profile) --------------------


def top_frames(samples: Dict[str, int], top: int = 25) -> List[dict]:
    """Per-frame self/total attribution over a folded flame table:
    ``self`` counts stacks where the frame is the leaf, ``total``
    counts every stack containing it — the two columns a human reads
    first."""
    grand = sum(samples.values()) or 1
    self_counts: Dict[str, int] = {}
    total_counts: Dict[str, int] = {}
    for stack, count in samples.items():
        frames = stack.split(";")
        self_counts[frames[-1]] = (
            self_counts.get(frames[-1], 0) + count
        )
        for frame in set(frames):
            total_counts[frame] = total_counts.get(frame, 0) + count
    out = [
        {
            "frame": frame,
            "self": int(self_counts.get(frame, 0)),
            "total": int(total),
            "self_pct": round(
                100.0 * self_counts.get(frame, 0) / grand, 2
            ),
            "total_pct": round(100.0 * total / grand, 2),
        }
        for frame, total in total_counts.items()
    ]
    out.sort(key=lambda d: (-d["self"], -d["total"], d["frame"]))
    return out[: int(top)]
