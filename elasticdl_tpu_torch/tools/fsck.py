"""Umbrella fsck: discover every auditable artifact under a root and
run the matching ``elasticdl_tpu_torch/tools/check_*.py`` validator on
it (the port's copy of ``tools/fsck.py``; the same verdicts and output).

Usage::

    python -m elasticdl_tpu_torch.tools.fsck [ROOT]   # default: cwd

Each chaos drill wires its own validator subset (tiered → check_store,
master kill → check_journal, …); this walks ``ROOT`` once and
dispatches by artifact signature, so nothing goes unaudited:

- ``journal.log``                    → check_journal (master WAL)
- ``version-*/`` or ``delta-*/``     → check_checkpoint (chains; a
  sibling push log in ``<dir>/pushlog`` or ``<dir>_pushlog`` is
  coverage-checked against the chain)
- cold-store ``MANIFEST.json``       → check_store (tiered spill)
- pushlog ``MANIFEST.json``          → check_pushlog (row WAL)
- ``alert.json``                     → check_incident (SLO bundles)
- ``shard_map.json``                 → check_reshard (authority state)
- ``USAGE_DRILL.json``               → check_usage (attribution drill)
- ``SCHED_DRILL.json``               → check_sched (gang-sched drill)
- ``STREAM_DRILL.json``              → check_stream (streaming drill)
- ``PROBE_DRILL.json``               → check_probe (synthetic probes)
- ``BROWNOUT_DRILL.json``            → check_overload (brownout drill)

Exits nonzero if any validator fails. A root with no artifacts passes
(there is nothing to corrupt). Importable: ``run_fsck(root)``.
"""

import json
import os
import sys
from typing import List, Tuple

_SKIP_DIRS = {".git", "__pycache__", "node_modules", ".claude"}


def _classify(root: str) -> List[Tuple[str, str]]:
    """[(kind, path)] for every artifact under ``root``. Checkpoint
    dirs are reported once (the dir holding the version-*/delta-*
    elements), not per element."""
    found: List[Tuple[str, str]] = []
    seen_ckpt = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        if "journal.log" in filenames:
            found.append(("journal", dirpath))
        if "alert.json" in filenames:
            found.append(("incident", dirpath))
        if "shard_map.json" in filenames:
            found.append(
                ("reshard", os.path.join(dirpath, "shard_map.json"))
            )
        if "USAGE_DRILL.json" in filenames:
            found.append(
                ("usage", os.path.join(dirpath, "USAGE_DRILL.json"))
            )
        if "SCHED_DRILL.json" in filenames:
            found.append(
                ("sched", os.path.join(dirpath, "SCHED_DRILL.json"))
            )
        if "STREAM_DRILL.json" in filenames:
            found.append(
                ("stream",
                 os.path.join(dirpath, "STREAM_DRILL.json"))
            )
        if "PROBE_DRILL.json" in filenames:
            found.append(
                ("probe",
                 os.path.join(dirpath, "PROBE_DRILL.json"))
            )
        if "BROWNOUT_DRILL.json" in filenames:
            found.append(
                ("overload",
                 os.path.join(dirpath, "BROWNOUT_DRILL.json"))
            )
        if "MANIFEST.json" in filenames:
            try:
                with open(
                    os.path.join(dirpath, "MANIFEST.json")
                ) as fh:
                    manifest = json.load(fh)
            except (OSError, ValueError):
                manifest = {}
            if manifest.get("format") == "pushlog-v1":
                found.append(("pushlog", dirpath))
            elif "record_bytes" in manifest or "dim" in manifest:
                found.append(("store", dirpath))
        if dirpath not in seen_ckpt and any(
            d.startswith(("version-", "delta-")) for d in dirnames
        ):
            seen_ckpt.add(dirpath)
            found.append(("checkpoint", dirpath))
    return sorted(found)


def _sibling_checkpoint(pushlog_dir: str) -> str:
    """The checkpoint dir a push log is fenced to, by layout
    convention (row_service main: --push_log_dir next to
    --checkpoint_dir); empty when none is recognizable."""
    parent = os.path.dirname(pushlog_dir.rstrip("/"))
    base = os.path.basename(pushlog_dir.rstrip("/"))
    candidates = []
    if base.endswith("_pushlog"):
        candidates.append(
            os.path.join(parent, base[: -len("_pushlog")])
        )
    if base in ("pushlog", "wal"):
        # The <dir>/{ckpt,pushlog} sibling layout (the quake drill's
        # shards) checks coverage too, not just <ckpt>/pushlog.
        candidates += [os.path.join(parent, "ckpt"),
                       os.path.join(parent, "rows"), parent]
    for cand in candidates:
        if os.path.isdir(cand) and any(
            e.startswith(("version-", "delta-"))
            for e in os.listdir(cand)
        ):
            return cand
    return ""


def run_fsck(root: str) -> Tuple[List[str], dict]:
    from elasticdl_tpu_torch.tools.check_checkpoint import check_checkpoint
    from elasticdl_tpu_torch.tools.check_incident import check_incident
    from elasticdl_tpu_torch.tools.check_journal import check_journal
    from elasticdl_tpu_torch.tools.check_overload import check_overload
    from elasticdl_tpu_torch.tools.check_probe import check_probe
    from elasticdl_tpu_torch.tools.check_pushlog import check_one_log
    from elasticdl_tpu_torch.tools.check_reshard import check_reshard
    from elasticdl_tpu_torch.tools.check_sched import check_sched
    from elasticdl_tpu_torch.tools.check_store import check_one_store
    from elasticdl_tpu_torch.tools.check_stream import check_stream
    from elasticdl_tpu_torch.tools.check_usage import check_usage

    artifacts = _classify(root)
    errors: List[str] = []
    checked = {"journal": 0, "checkpoint": 0, "store": 0,
               "pushlog": 0, "incident": 0, "reshard": 0,
               "usage": 0, "sched": 0, "stream": 0, "probe": 0,
               "overload": 0}
    for kind, path in artifacts:
        checked[kind] += 1
        try:
            if kind == "journal":
                errs = check_journal(path)
            elif kind == "checkpoint":
                errs, _report = check_checkpoint(path)
            elif kind == "store":
                errs, _report = check_one_store(path)
            elif kind == "pushlog":
                errs, _report = check_one_log(
                    path, _sibling_checkpoint(path) or None
                )
            elif kind == "incident":
                errs = check_incident(path)
            elif kind == "usage":
                errs, _report = check_usage(path)
            elif kind == "sched":
                errs, _report = check_sched(path)
            elif kind == "stream":
                errs, _report = check_stream(path)
            elif kind == "probe":
                errs, _report = check_probe(path)
            elif kind == "overload":
                errs, _report = check_overload(path)
            else:  # reshard
                errs, _report = check_reshard(path)
        except BaseException as exc:
            errs = [f"validator crashed: {type(exc).__name__}: {exc}"]
        errors += [f"{kind} {path}: {e}" for e in errs]
    return errors, {"artifacts": artifacts, "checked": checked}


def main(argv=None) -> int:
    root = (argv or sys.argv[1:] or ["."])[0]
    errors, report = run_fsck(root)
    for kind, path in report["artifacts"]:
        print(f"  {kind:10s} {path}")
    summary = ", ".join(
        f"{n} {kind}(s)" for kind, n in sorted(
            report["checked"].items()
        ) if n
    ) or "no artifacts"
    if errors:
        print(f"FSCK FAIL under {root} ({summary}): "
              f"{len(errors)} error(s)")
        for err in errors:
            print(f"  - {err}")
        return 1
    print(f"FSCK OK under {root} ({summary})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
