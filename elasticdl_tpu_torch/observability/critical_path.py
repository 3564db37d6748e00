"""Critical-path + straggler attribution over collected span trees (port
of elasticdl_tpu/observability/critical_path.py).

Reduces a run's spans (``tracing`` dicts) into the question the
histogram tail can't answer: *which phase dominated the slow tasks and
the slow steps?* A task span's direct children are its phases (the
get_task RPC, per-batch fetch / device_step, checkpoint, the report
RPC); whatever the children don't cover is ``self`` time. The report
names the dominant phase of the p99 task and the p99 step, and breaks
p50 vs p99 down per phase so a fat tail with a healthy median reads as
"row pulls stall the stragglers", not just "p99 is high".
"""

import json
from typing import Dict, List, Optional

TASK_SPAN = "task"
STEP_SPAN = "device_step"
SELF_PHASE = "self"


def build_index(spans: List[dict]):
    """(by_id, children) maps; children lists keep recording order."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    children: Dict[str, List[dict]] = {}
    for s in spans:
        parent = s.get("parent_id")
        if parent:
            children.setdefault(parent, []).append(s)
    return by_id, children


def subtree(span: dict, children: Dict[str, List[dict]]) -> List[dict]:
    """The span plus every descendant reachable through parent links."""
    out = []
    todo = [span]
    while todo:
        node = todo.pop()
        out.append(node)
        todo.extend(children.get(node.get("span_id"), ()))
    return out


def phase_breakdown(span: dict,
                    children: Dict[str, List[dict]]) -> Dict[str, float]:
    """Direct-child durations grouped by span name, plus ``self`` (the
    parent's time not covered by any child). Children overlapping the
    parent's end (async stragglers) are clamped into it."""
    total = float(span.get("dur", 0.0))
    phases: Dict[str, float] = {}
    covered = 0.0
    for child in children.get(span.get("span_id"), ()):
        dur = min(float(child.get("dur", 0.0)), total)
        phases[child["name"]] = phases.get(child["name"], 0.0) + dur
        covered += dur
    phases[SELF_PHASE] = max(0.0, total - covered)
    return phases


def dominant_phase(phases: Dict[str, float]) -> str:
    if not phases:
        return SELF_PHASE
    return max(sorted(phases), key=lambda k: phases[k])


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 on empty input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(len(ordered) - 1, max(0, int(round(
        (q / 100.0) * (len(ordered) - 1)
    ))))
    return ordered[rank]


def _attributed(span: dict, children) -> dict:
    phases = phase_breakdown(span, children)
    return {
        "dur_secs": round(float(span.get("dur", 0.0)), 6),
        "role": span.get("role"),
        "instance": span.get("instance"),
        "attrs": span.get("attrs", {}),
        "dominant_phase": dominant_phase(phases),
        "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
    }


def _group_report(group: List[dict], children, top_k: int) -> dict:
    durs = [float(s.get("dur", 0.0)) for s in group]
    p50 = percentile(durs, 50)
    p99 = percentile(durs, 99)
    by_dur = sorted(group, key=lambda s: float(s.get("dur", 0.0)))
    # The attributed exemplar is the span AT the nearest-rank p99, not
    # the max — in large groups a single extreme outlier must not make
    # the headline "p99 task" contradict p99_secs (the outlier still
    # shows up in stragglers).
    p99_span = None
    if by_dur:
        idx = min(len(by_dur) - 1, max(0, int(round(
            0.99 * (len(by_dur) - 1)
        ))))
        p99_span = by_dur[idx]

    def mean_phases(selection: List[dict]) -> Dict[str, float]:
        acc: Dict[str, float] = {}
        for s in selection:
            for name, dur in phase_breakdown(s, children).items():
                acc[name] = acc.get(name, 0.0) + dur
        n = max(1, len(selection))
        return {k: round(v / n, 6) for k, v in sorted(acc.items())}

    fast = [s for s in by_dur if float(s.get("dur", 0.0)) <= p50]
    slow = [s for s in by_dur if float(s.get("dur", 0.0)) >= p99] or (
        [p99_span] if p99_span else []
    )
    return {
        "count": len(group),
        "p50_secs": round(p50, 6),
        "p99_secs": round(p99, 6),
        "p50_phase_means": mean_phases(fast),
        "p99_phase_means": mean_phases(slow),
        "p99": _attributed(p99_span, children) if p99_span else None,
        "stragglers": [
            _attributed(s, children) for s in reversed(by_dur[-top_k:])
        ],
    }


def analyze(spans: List[dict], top_k: int = 3) -> dict:
    """The critical-path / straggler report for one collected run."""
    _, children = build_index(spans)
    tasks = [s for s in spans if s.get("name") == TASK_SPAN]
    steps = [s for s in spans if s.get("name") == STEP_SPAN]
    report = {
        "span_count": len(spans),
        "trace_count": len({s.get("trace_id") for s in spans}),
        "tasks": _group_report(tasks, children, top_k) if tasks else None,
        "steps": _group_report(steps, children, top_k) if steps else None,
    }
    return report


def render_report(report: dict) -> str:
    """Human-oriented text rendering of ``analyze()``'s dict."""
    lines = [
        f"spans: {report['span_count']}  "
        f"traces: {report['trace_count']}",
    ]
    for kind in ("tasks", "steps"):
        group = report.get(kind)
        if not group:
            lines.append(f"{kind}: none recorded")
            continue
        lines.append(
            f"{kind}: n={group['count']}  p50={group['p50_secs']:.4f}s  "
            f"p99={group['p99_secs']:.4f}s"
        )
        p99 = group.get("p99")
        if p99:
            phases = ", ".join(
                f"{name}={dur:.4f}s"
                for name, dur in p99["phases"].items() if dur > 0
            )
            lines.append(
                f"  p99 {kind[:-1]}: {p99['dur_secs']:.4f}s "
                f"dominated by [{p99['dominant_phase']}]  ({phases})"
            )
        lines.append(
            "  p50 phase means: " + json.dumps(group["p50_phase_means"])
        )
        lines.append(
            "  p99 phase means: " + json.dumps(group["p99_phase_means"])
        )
    return "\n".join(lines) + "\n"
