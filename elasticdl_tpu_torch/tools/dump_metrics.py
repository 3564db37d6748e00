"""Scrape a running master's /metrics and pretty-print it (the port's
copy of ``tools/dump_metrics.py``; the same renderings).

Usage (``M`` = ``python -m elasticdl_tpu_torch.tools.dump_metrics``)::

    M localhost:8080            # pretty table
    M http://host:port --raw    # exposition text
    M localhost:8080 --traces   # + span trees
    M localhost:8080 --alerts   # + /alerts
    M localhost:8080 --profile rowservice-0
    M localhost:8080 --usage    # + /usage
    M localhost:8080 --probes   # + /probes
    M localhost:8080 --overload # shed view
    M localhost:8080 --watch 5  # live redraw

Works against any Prometheus text endpoint — the in-process test
cluster (``MiniCluster(metrics_port=0)``), a real master started with
``--metrics_port``, or a row-service process wired to serve its own
registry. ``--traces`` additionally fetches the sibling ``/traces``
endpoint (the flight recorder / master trace collection, served when
the process runs with ``--flight_recorder N``) and pretty-prints each
trace as an indented span tree with durations. ``--alerts`` fetches
``/alerts`` (the SLO engine's rule states, served when the master runs
with ``--timeseries_secs > 0``) and renders a firing/ok table.
``--usage`` fetches ``/usage`` (the workload-attribution rollup, see
docs/observability.md "Workload attribution") and renders who-pays
share tables: fleet totals, per-principal shares, per-purpose handler
time, and the top-K principals per shard.
``--watch N`` redraws everything every N seconds until interrupted —
the terminal equivalent of a dashboard, no curl+jq loop required.
Stdlib only (urllib), like the endpoints themselves.
"""

import argparse
import json
import re
import sys
import time
import urllib.request

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{.*?\})?\s+(?P<value>\S+)"
    # Optional OpenMetrics exemplar suffix on histogram bucket lines:
    # ` # {trace_id="..."} value ts` (docs/observability.md).
    r"(?P<exemplar>\s+#\s+\{.*\}\s+\S+(\s+\S+)?)?$"
)


def normalize_url(addr: str) -> str:
    if not addr.startswith("http://") and not addr.startswith("https://"):
        addr = f"http://{addr}"
    if not addr.rstrip("/").endswith("/metrics"):
        addr = addr.rstrip("/") + "/metrics"
    return addr


def fetch_metrics(addr: str, timeout: float = 10.0) -> str:
    with urllib.request.urlopen(
        normalize_url(addr), timeout=timeout
    ) as resp:
        return resp.read().decode("utf-8")


def parse_samples(text: str):
    """Yield (family_help, family_type) headers and samples as dicts."""
    families = {}
    order = []
    current_help = {}
    current_type = {}
    for line in text.splitlines():
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            current_help[name] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            current_type[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        sample_name = m.group("name")
        # _bucket/_sum/_count samples belong to their histogram family.
        base = re.sub(r"_(bucket|sum|count)$", "", sample_name)
        family = base if base in current_type else sample_name
        if family not in families:
            families[family] = []
            order.append(family)
        families[family].append(
            (sample_name, m.group("labels") or "", m.group("value"))
        )
    return order, families, current_help, current_type


def pretty_print(text: str, out=None):
    out = out if out is not None else sys.stdout
    order, families, helps, types = parse_samples(text)
    for family in order:
        kind = types.get(family, "untyped")
        out.write(f"{family}  [{kind}]  {helps.get(family, '')}\n")
        samples = families[family]
        if kind == "histogram":
            # Collapse buckets into one line per series: count/sum only
            # (buckets are for Prometheus, not eyeballs).
            for name, labels, value in samples:
                if name.endswith("_count") or name.endswith("_sum"):
                    out.write(f"    {name}{labels} = {value}\n")
        else:
            for name, labels, value in samples:
                out.write(f"    {name}{labels} = {value}\n")
        out.write("\n")


# Overload-plane families (suffix match: the registry namespaces
# them, e.g. edl_tpu_overload_shed_total). docs/fault_tolerance.md
# "Graceful degradation".
_OVERLOAD_FAMILIES = (
    "overload_shed_total",
    "overload_queue_depth",
    "rpc_retries_total",
    "rpc_retry_budget_exhausted_total",
    "rpc_breaker_state",
    "rpc_hedge_attempts_total",
    "rpc_hedge_wins_total",
    "row_push_durable_wait_timeouts_total",
)


def print_overload(text: str, out=None):
    """The overload-plane slice of a scrape: who is being shed (by
    purpose), queue depth against the admission limit, retry volume
    and budget exhaustions, breaker states, hedge traffic — the
    at-a-glance brownout dashboard."""
    out = out if out is not None else sys.stdout
    order, families, helps, types = parse_samples(text)
    hits = [f for f in order if f.endswith(_OVERLOAD_FAMILIES)]
    if not hits:
        out.write("  (no overload-plane families in this scrape — "
                  "nothing shed, retried, or broken yet)\n")
        return
    for family in hits:
        kind = types.get(family, "untyped")
        out.write(f"{family}  [{kind}]  {helps.get(family, '')}\n")
        for name, labels, value in families[family]:
            if kind == "histogram" and not (
                name.endswith("_count") or name.endswith("_sum")
            ):
                continue
            out.write(f"    {name}{labels} = {value}\n")
        out.write("\n")


def traces_url(addr: str) -> str:
    return sibling_url(addr, "/traces")


def fetch_traces(addr: str, timeout: float = 10.0) -> list:
    """Span dicts from the process's /traces endpoint (flight recorder
    or master trace collection)."""
    with urllib.request.urlopen(
        traces_url(addr), timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode("utf-8")).get("spans", [])


def print_spans(spans: list, out=None):
    """Indented span trees, one block per trace, children under their
    parents in start order."""
    out = out if out is not None else sys.stdout
    if not spans:
        out.write("no spans recorded (is a flight recorder "
                  "installed? --flight_recorder N)\n")
        return
    by_id = {s.get("span_id"): s for s in spans}
    children = {}
    roots = []
    for s in sorted(spans, key=lambda s: float(s.get("t0", 0.0))):
        parent = s.get("parent_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)

    def emit(span, depth):
        attrs = span.get("attrs") or {}
        attr_text = (
            "  " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            if attrs else ""
        )
        out.write(
            f"{'  ' * depth}{span.get('name')}  "
            f"[{span.get('role')}/{span.get('instance')}]  "
            f"{float(span.get('dur', 0.0)) * 1e3:.3f}ms{attr_text}\n"
        )
        for child in children.get(span.get("span_id"), ()):
            emit(child, depth + 1)

    # One block per trace even when traces' roots interleave in time
    # (multi-worker runs): group roots by trace id, traces ordered by
    # their first root's start.
    by_trace = {}
    for root in roots:
        by_trace.setdefault(root.get("trace_id"), []).append(root)
    for trace, trace_roots in by_trace.items():
        out.write(f"trace {trace}\n")
        for root in trace_roots:
            emit(root, 1)
    out.write(f"({len(spans)} spans, {len(roots)} roots)\n")


def sibling_url(addr: str, path: str) -> str:
    return normalize_url(addr).rsplit("/metrics", 1)[0] + path


def fetch_alerts(addr: str, timeout: float = 10.0) -> dict:
    """The SLO engine's /alerts body (docs/observability.md)."""
    with urllib.request.urlopen(
        sibling_url(addr, "/alerts"), timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode("utf-8"))


def fetch_profile(addr: str, component: str, window: float,
                  timeout: float = 10.0) -> dict:
    """The continuous-profiling plane's /profile body for one
    component (docs/observability.md "Continuous profiling &
    exemplars")."""
    import urllib.parse as _parse

    query = _parse.urlencode(
        {"component": component, "window": window}
    )
    with urllib.request.urlopen(
        sibling_url(addr, f"/profile?{query}"), timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode("utf-8"))


def print_profile(profile: dict, top: int = 20, out=None):
    """Top-N frames by self time (self/total %), then the heaviest
    folded stacks — the terminal flame graph."""
    from elasticdl_tpu_torch.observability.profiler import top_frames

    out = out if out is not None else sys.stdout
    if profile.get("error"):
        out.write(f"no profile: {profile['error']}\n")
        for comp in profile.get("components", []):
            out.write(
                f"  available: {comp.get('component')!r} "
                f"({comp.get('role')}/{comp.get('instance')}, "
                f"{comp.get('windows')} windows)\n"
            )
        return
    window = profile.get("window") or {}
    samples = window.get("samples") or {}
    total = sum(samples.values())
    out.write(
        f"component {profile.get('component')!r}: "
        f"{window.get('sample_count', 0)} passes / {total} samples "
        f"over {float(window.get('t1', 0)) - float(window.get('t0', 0)):.1f}s "
        f"at {window.get('hz', 0):g} Hz "
        f"(threads: {window.get('threads')})\n"
    )
    out.write(f"{'self%':>7} {'total%':>7}  frame\n")
    for row in top_frames(samples, top=top):
        out.write(
            f"{row['self_pct']:>6.2f}% {row['total_pct']:>6.2f}%  "
            f"{row['frame']}\n"
        )
    out.write("\nheaviest stacks:\n")
    heaviest = sorted(
        samples.items(), key=lambda kv: (-kv[1], kv[0])
    )[:10]
    for stack, count in heaviest:
        share = 100.0 * count / total if total else 0.0
        out.write(f"  {share:5.1f}%  {stack}\n")
    diff = profile.get("diff")
    if diff:
        out.write("\nvs base window (share deltas):\n")
        for row in diff[:10]:
            out.write(
                f"  {row['delta_frac'] * 100:+6.2f}%  {row['stack']}\n"
            )


def fetch_usage(addr: str, top: int, timeout: float = 10.0) -> dict:
    """The workload-attribution plane's /usage body
    (docs/observability.md "Workload attribution")."""
    with urllib.request.urlopen(
        sibling_url(addr, f"/usage?top={int(top)}"), timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode("utf-8"))


def fetch_sched(addr: str, timeout: float = 10.0) -> dict:
    """The gang scheduler's /sched body (docs/scheduler.md): job
    table, slot allocation, fair-share vs consumed usage share,
    preemption counts."""
    with urllib.request.urlopen(
        sibling_url(addr, "/sched"), timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode("utf-8"))


def print_sched(sched: dict, out=None):
    """The job table: one row per job with lifecycle state, gang vs
    allocated slots, fair-share target vs actually-consumed usage
    share, and preemption counts."""
    out = out if out is not None else sys.stdout
    jobs = sched.get("jobs") or {}
    if sched.get("error") or not jobs:
        out.write(
            f"no scheduler data ({sched.get('error', 'no jobs')};"
            " master needs --sched)\n"
        )
        return
    slots = sched.get("slots") or {}
    out.write(
        f"slots: {slots.get('allocated', 0)}/{slots.get('total', 0)} "
        f"allocated, {sched.get('preemptions', 0)} preemption(s) "
        "total\n\n"
    )
    out.write(
        f"{'job':<16} {'state':<10} {'prio':>4} {'gang':>4} "
        f"{'alloc':>5} {'bound':>5} {'todo':>5} {'doing':>5} "
        f"{'preempt':>7} {'fair%':>6} {'used%':>6}\n"
    )
    order = sorted(
        jobs.items(),
        key=lambda kv: (-int(kv[1].get("priority", 0)), kv[0]),
    )
    for job, row in order:
        out.write(
            f"{job:<16} {row.get('state', ''):<10} "
            f"{row.get('priority', 0):>4} "
            f"{row.get('gang_size', 0):>4} "
            f"{row.get('allocated_slots', 0):>5} "
            f"{row.get('bound_workers', 0):>5} "
            f"{row.get('todo', 0):>5} {row.get('doing', 0):>5} "
            f"{row.get('preemptions', 0):>7} "
            f"{100.0 * float(row.get('fair_share', 0)):>5.1f}% "
            f"{100.0 * float(row.get('usage_share', 0)):>5.1f}%\n"
        )


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def print_usage(usage: dict, out=None):
    """Who-pays tables: totals, per-principal shares sorted by bytes,
    per-purpose handler time, and top-K principals per shard."""
    out = out if out is not None else sys.stdout
    principals = usage.get("principals") or []
    if usage.get("error") or not principals:
        out.write(
            f"no usage data ({usage.get('error', 'nothing metered')};"
            " are callers principal-tagged?)\n"
        )
        return
    totals = usage.get("totals") or {}
    out.write(
        f"totals: {totals.get('requests', 0):.0f} requests, "
        f"{totals.get('rows', 0):.0f} rows, "
        f"{_fmt_bytes(float(totals.get('bytes', 0)))}, "
        f"{float(totals.get('handler_seconds', 0)):.2f}s handler, "
        f"{float(totals.get('lock_hold_seconds', 0)):.2f}s lock-hold\n"
    )
    out.write(
        f"attributed handler share: "
        f"{100.0 * float(usage.get('attributed_handler_share', 0)):.1f}%\n\n"
    )
    out.write(
        f"{'job':<16} {'component':<10} {'purpose':<15} "
        f"{'req%':>6} {'rows%':>6} {'bytes%':>6}  {'bytes':>10}\n"
    )
    for row in principals:
        who = row.get("principal") or {}
        share = row.get("share") or {}
        out.write(
            f"{who.get('job', ''):<16} "
            f"{who.get('component', ''):<10} "
            f"{who.get('purpose', ''):<15} "
            f"{100.0 * float(share.get('requests', 0)):>5.1f}% "
            f"{100.0 * float(share.get('rows', 0)):>5.1f}% "
            f"{100.0 * float(share.get('bytes', 0)):>5.1f}%  "
            f"{_fmt_bytes(float(row.get('bytes', 0))):>10}\n"
        )
    purposes = usage.get("purposes") or {}
    if purposes:
        out.write("\nhandler time by purpose:\n")
        for purpose, row in sorted(
            purposes.items(),
            key=lambda kv: -float(kv[1].get("handler_seconds", 0)),
        ):
            out.write(
                f"  {purpose:<15} "
                f"{float(row.get('handler_seconds', 0)):>8.2f}s "
                f"{100.0 * float(row.get('share', 0)):>5.1f}%\n"
            )
    shards = usage.get("shards") or {}
    for reporter in sorted(shards):
        out.write(f"\nshard {reporter or '(master)'} top principals:\n")
        for row in shards[reporter].get("top", []):
            who = row.get("principal") or {}
            out.write(
                f"  {who.get('job', '')}/{who.get('component', '')}"
                f"/{who.get('purpose', '')}: "
                f"{row.get('requests', 0):.0f} req, "
                f"{row.get('rows', 0):.0f} rows, "
                f"{_fmt_bytes(float(row.get('bytes', 0)))}\n"
            )


def fetch_stream(addr: str, timeout: float = 10.0) -> dict:
    """The streaming-ingestion plane's /stream body
    (docs/online_learning.md): per-partition watermarks, lag, and
    backpressure."""
    with urllib.request.urlopen(
        sibling_url(addr, "/stream"), timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode("utf-8"))


def print_stream(stream: dict, out=None):
    """One row per partition: appended end vs generated cursor vs
    committed watermark, lag in records and seconds, pending
    (in-flight) ranges; then the ingestor's backpressure totals."""
    out = out if out is not None else sys.stdout
    partitions = stream.get("partitions") or {}
    if stream.get("error") or not partitions:
        out.write(
            f"no stream data ({stream.get('error', 'no partitions')};"
            " master needs --stream_dir)\n"
        )
        return
    out.write(
        f"{'partition':<16} {'end':>8} {'next':>8} {'committed':>9} "
        f"{'pending':>7} {'lag':>8} {'lag_secs':>8}\n"
    )
    for partition in sorted(partitions):
        row = partitions[partition]
        out.write(
            f"{partition:<16} {row.get('end', 0):>8} "
            f"{row.get('next', 0):>8} {row.get('committed', 0):>9} "
            f"{row.get('pending_ranges', 0):>7} "
            f"{row.get('lag_records', 0):>8} "
            f"{float(row.get('watermark_lag_seconds', 0.0)):>8.2f}\n"
        )
    out.write(
        f"\nbackpressure: "
        f"{'YES' if stream.get('backpressured') else 'no'} now, "
        f"{float(stream.get('backpressure_seconds', 0.0)):.2f}s total "
        f"(max_todo {stream.get('max_todo', 0)})\n"
    )
    every = int(stream.get("eval_every_records", 0) or 0)
    if every:
        out.write(f"watermark eval: every {every} records\n")


def fetch_probes(addr: str, timeout: float = 10.0) -> dict:
    """The synthetic-probe plane's /probes body
    (docs/observability.md "Synthetic probing"): per-probe status,
    success ratio, latency, and the last failure."""
    with urllib.request.urlopen(
        sibling_url(addr, "/probes"), timeout=timeout
    ) as resp:
        return json.loads(resp.read().decode("utf-8"))


def print_probes(probes: dict, out=None):
    """One row per probe: green/red status, success ratio, last
    latency, consecutive failures, and the last failure's reason —
    the outside-in view of whether the deployment WORKS."""
    out = out if out is not None else sys.stdout
    table = probes.get("probes") or {}
    if probes.get("error") or not table:
        out.write(
            f"no probe data ({probes.get('error', 'none registered')};"
            " master needs --probes)\n"
        )
        return
    red = sorted(
        name for name, row in table.items()
        if row.get("status") == "red"
    )
    out.write(
        f"job {probes.get('job', '')!r} (purpose "
        f"{probes.get('purpose', '')}), canary ids "
        f"[{probes.get('canary_id_base', 0)}, +"
        f"{probes.get('canary_id_span', 0)}); "
        f"{len(red)}/{len(table)} red"
        f"{': ' + ', '.join(red) if red else ''}\n\n"
    )
    out.write(
        f"{'probe':<20} {'status':<7} {'ok%':>6} {'runs':>6} "
        f"{'consec':>6} {'lat_ms':>8}  last failure\n"
    )
    for name in sorted(table):
        row = table[name]
        attempts = int(row.get("attempts", 0))
        failures = int(row.get("failures", 0))
        ratio = (
            100.0 * (attempts - failures) / attempts if attempts
            else 0.0
        )
        last = ""
        if row.get("last_reason"):
            last = row["last_reason"]
            if row.get("last_error"):
                last += f": {row['last_error'][:60]}"
        out.write(
            f"{name:<20} {row.get('status', ''):<7} {ratio:>5.1f}% "
            f"{attempts:>6} {row.get('consecutive_failures', 0):>6} "
            f"{float(row.get('last_latency_secs', 0.0)) * 1e3:>8.2f}"
            f"  {last}\n"
        )


def print_alerts(alerts: dict, out=None):
    """One line per rule: state, value, human detail."""
    out = out if out is not None else sys.stdout
    rules = alerts.get("rules") or []
    if alerts.get("error") or not rules:
        out.write(
            f"no SLO rules ({alerts.get('error', 'none configured')};"
            " master needs --timeseries_secs > 0)\n"
        )
        return
    firing = alerts.get("firing") or []
    out.write(
        f"{len(firing)}/{len(rules)} rule(s) firing"
        f"{': ' + ', '.join(firing) if firing else ''}\n"
    )
    for rule in rules:
        state = "FIRING" if rule.get("firing") else "ok"
        since = rule.get("since")
        since_text = ""
        if rule.get("firing") and since and alerts.get("now"):
            since_text = f" for {alerts['now'] - since:.0f}s"
        out.write(
            f"  [{state:>6}]{since_text} {rule.get('rule')} "
            f"({rule.get('kind')} on {rule.get('series')})\n"
            f"           {rule.get('detail') or rule.get('description')}"
            "\n"
        )


def dump_once(args) -> int:
    try:
        text = fetch_metrics(args.addr, timeout=args.timeout)
    except OSError as exc:
        print(f"scrape failed: {exc}", file=sys.stderr)
        return 1
    if args.raw:
        sys.stdout.write(text)
    else:
        pretty_print(text)
    if args.overload:
        sys.stdout.write("\n---- overload ----\n")
        print_overload(text)
    if args.traces:
        try:
            spans = fetch_traces(args.addr, timeout=args.timeout)
        except OSError as exc:
            print(f"traces fetch failed: {exc} (endpoint serves "
                  "/traces only when tracing is wired)",
                  file=sys.stderr)
            return 1
        sys.stdout.write("\n---- traces ----\n")
        print_spans(spans)
    if args.alerts:
        try:
            alerts = fetch_alerts(args.addr, timeout=args.timeout)
        except OSError as exc:
            print(f"alerts fetch failed: {exc} (endpoint serves "
                  "/alerts only with --timeseries_secs > 0)",
                  file=sys.stderr)
            return 1
        sys.stdout.write("\n---- alerts ----\n")
        print_alerts(alerts)
    if args.usage:
        try:
            usage = fetch_usage(args.addr, args.usage_top,
                                timeout=args.timeout)
        except OSError as exc:
            print(f"usage fetch failed: {exc} (the master serves "
                  "/usage from its metrics port)", file=sys.stderr)
            return 1
        sys.stdout.write("\n---- usage ----\n")
        print_usage(usage)
    if args.sched:
        try:
            sched = fetch_sched(args.addr, timeout=args.timeout)
        except OSError as exc:
            print(f"sched fetch failed: {exc} (the master serves "
                  "/sched only with --sched)", file=sys.stderr)
            return 1
        sys.stdout.write("\n---- sched ----\n")
        print_sched(sched)
    if args.stream:
        try:
            stream = fetch_stream(args.addr, timeout=args.timeout)
        except OSError as exc:
            print(f"stream fetch failed: {exc} (the master serves "
                  "/stream only with --stream_dir)", file=sys.stderr)
            return 1
        sys.stdout.write("\n---- stream ----\n")
        print_stream(stream)
    if args.probes:
        try:
            probes = fetch_probes(args.addr, timeout=args.timeout)
        except OSError as exc:
            print(f"probes fetch failed: {exc} (the master serves "
                  "/probes only with --probes)", file=sys.stderr)
            return 1
        sys.stdout.write("\n---- probes ----\n")
        print_probes(probes)
    if args.profile is not None:
        try:
            profile = fetch_profile(
                args.addr, args.profile, args.profile_window,
                timeout=args.timeout,
            )
        except OSError as exc:
            print(f"profile fetch failed: {exc} (endpoint serves "
                  "/profile when something runs --profile_hz)",
                  file=sys.stderr)
            return 1
        sys.stdout.write("\n---- profile ----\n")
        print_profile(profile, top=args.profile_top)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("dump_metrics")
    parser.add_argument("addr", help="host:port or URL of the master "
                                     "metrics endpoint")
    parser.add_argument("--raw", action="store_true",
                        help="Print the exposition text verbatim")
    parser.add_argument("--traces", action="store_true",
                        help="Also fetch /traces and print the flight "
                             "recorder as indented span trees")
    parser.add_argument("--alerts", action="store_true",
                        help="Also fetch /alerts and print the SLO "
                             "rule states")
    parser.add_argument("--usage", action="store_true",
                        help="Also fetch /usage and print per-workload "
                             "share tables (who pays for requests, "
                             "rows, bytes, lock-hold)")
    parser.add_argument("--usage_top", type=int, default=5,
                        help="Top-K principals per shard in the "
                             "--usage view")
    parser.add_argument("--sched", action="store_true",
                        help="Also fetch /sched and print the gang "
                             "scheduler's job table (state, gang vs "
                             "allocated slots, fair-share vs consumed "
                             "usage, preemptions)")
    parser.add_argument("--stream", action="store_true",
                        help="Also fetch /stream and print the "
                             "streaming-ingestion watermark table "
                             "(per-partition end/next/committed, lag, "
                             "backpressure)")
    parser.add_argument("--probes", action="store_true",
                        help="Also fetch /probes and print the "
                             "synthetic-probe table (green/red, "
                             "success ratio, latency, last failure "
                             "reason)")
    parser.add_argument("--overload", action="store_true",
                        help="Also print the overload-plane slice of "
                             "the scrape (sheds by purpose, queue "
                             "depth, retry budgets, breaker states, "
                             "hedges) as its own section")
    parser.add_argument("--profile", default=None, metavar="COMPONENT",
                        help="Also fetch /profile for this component "
                             "('' = the master itself, '3' = worker "
                             "3, 'rowservice-0' etc.) and print the "
                             "top folded stacks (self/total %%)")
    parser.add_argument("--profile_window", type=float, default=60.0,
                        help="Profile window to merge (seconds back "
                             "from now)")
    parser.add_argument("--profile_top", type=int, default=20,
                        help="How many frames/stacks to print")
    parser.add_argument("--watch", type=float, default=0.0,
                        metavar="SECS",
                        help="Redraw every SECS seconds until "
                             "interrupted (ctrl-C exits cleanly)")
    parser.add_argument("--timeout", type=float, default=10.0)
    args = parser.parse_args(argv)
    if args.watch <= 0:
        return dump_once(args)
    try:
        while True:
            # ANSI clear + home: redraw in place like `watch(1)`.
            sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(
                f"{args.addr}  every {args.watch:g}s  "
                f"{time.strftime('%H:%M:%S')}\n\n"
            )
            dump_once(args)
            sys.stdout.flush()
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
