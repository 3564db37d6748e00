"""Fsck for row-service write-ahead push logs
(``elasticdl_tpu_torch/storage/pushlog.py``), the port's copy of
``tools/check_pushlog.py``: the same checks, report fields and exit
codes (0 clean, 1 errors). It reads either package's logs (the bytes
are the same).

Usage::

    python -m elasticdl_tpu_torch.tools.check_pushlog LOG_DIR \
        [--checkpoint CKPT_DIR]

``LOG_DIR`` is either one log (a dir holding ``MANIFEST.json`` with
``format: pushlog-v1`` plus ``pushlog-*.wal`` segments) or a tree of
them: every log found underneath is audited.

Validates per log (returning human-readable errors, empty = pass):

- **framing/CRC per segment**: every record is length-prefixed,
  ``EDLC1``-framed, CRC-verified msgpack with the full record schema
  (version, client, seq, table, int64 ids, matching float32 grads,
  applied_at, map_version). A torn TAIL on the newest segment is
  *reported* (a SIGKILLed incarnation's last group commit — recovery
  truncates it), a tear anywhere else is an error;
- **version monotonicity + covered gaps**: record versions must be
  strictly increasing across segments in segment order — the log is
  a total order of the shard's applies. A FORWARD gap is legal only
  when a durable checkpoint covers the missing versions (a SIGKILL
  can drop queued group commits the chain already covers — the
  relaunch restores the chain tip and continues from tip+1); with
  ``--checkpoint`` an uncovered gap is an error, without it gaps are
  reported (``version_gaps``) for a caller that knows the tip;
- **per-client seq monotonicity**: for each (client) stream, seqs
  must be strictly increasing — a regression means the exactly-once
  dedup would mis-drop or double-apply on replay;
- **coverage vs checkpoint meta** (``--checkpoint``): the log's first
  record version must not open a gap past the chain's newest durable
  version (``CheckpointSaver`` chain walk) — i.e. every version in
  ``(tip, log_head)`` is covered by either the chain or the log.
  Truncation is fenced to checkpoint publish, so a gap here means a
  segment was reclaimed that the chain does not cover.

Importable from tests (``check_pushlog(path, checkpoint_dir=None)``).
"""

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

def find_logs(path: str) -> List[str]:
    """Every push-log dir (MANIFEST.json with the pushlog format)
    under ``path``."""
    from elasticdl_tpu_torch.storage.pushlog import (
        MANIFEST_FILE,
        PUSHLOG_FORMAT,
    )

    out = []
    for root, _dirs, files in os.walk(path):
        if MANIFEST_FILE not in files:
            continue
        try:
            with open(os.path.join(root, MANIFEST_FILE)) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            continue
        if manifest.get("format") == PUSHLOG_FORMAT:
            out.append(root)
    return sorted(out)


def check_one_log(path: str,
                  checkpoint_dir: Optional[str] = None
                  ) -> Tuple[List[str], dict]:
    """Audit one push-log dir. Returns (errors, report)."""
    from elasticdl_tpu_torch.storage.pushlog import (
        SEGMENT_RE,
        scan_segment,
    )

    errors: List[str] = []
    report = {
        "path": path,
        "segments": 0,
        "records": 0,
        "bytes": 0,
        "first_version": None,
        "last_version": None,
        "clients": 0,
        "torn_tail": None,
        "covered_by_checkpoint": None,
        # Forward version gaps [(last_before, first_after), ...]:
        # legal iff a durable checkpoint covers the missing range
        # (validated below when --checkpoint is given).
        "version_gaps": [],
    }
    segs = sorted(
        (int(m.group(1)), entry)
        for entry in os.listdir(path)
        for m in [SEGMENT_RE.match(entry)]
        if m
    )
    report["segments"] = len(segs)
    last_version = None
    last_seq_per_client = {}
    newest = segs[-1][0] if segs else None
    for seg, entry in segs:
        seg_path = os.path.join(path, entry)
        records, torn = scan_segment(seg_path)
        report["bytes"] += os.path.getsize(seg_path)
        if torn is not None:
            if seg == newest:
                # A SIGKILLed incarnation's torn group commit: the
                # reopen truncates it, replay loses only records
                # whose fsync never completed (never durably acked).
                report["torn_tail"] = f"segment {seg}: {torn}"
            else:
                errors.append(
                    f"{seg_path}: sealed segment torn mid-log "
                    f"({torn}); only the newest segment may tear"
                )
        for _off, _end, record in records:
            report["records"] += 1
            v = int(record["v"])
            if report["first_version"] is None:
                report["first_version"] = v
            if last_version is not None and v <= last_version:
                errors.append(
                    f"{seg_path}: version regression: record v{v} "
                    f"follows v{last_version} (the log is a total "
                    "order of applies)"
                )
            elif (last_version is not None
                    and v != last_version + 1):
                # A forward gap: a SIGKILL can drop queued group
                # commits that a durable checkpoint ALREADY covered
                # (the chain publishes independently of the WAL
                # queue); the relaunch then continues from tip+1.
                # Whether this gap was covered is judged against the
                # checkpoint below.
                report["version_gaps"].append([last_version, v])
            last_version = v
            client = str(record.get("client") or "")
            seq = int(record.get("seq", -1))
            if client and seq >= 0:
                prev = last_seq_per_client.get(client)
                if prev is not None and seq <= prev:
                    errors.append(
                        f"{seg_path}: client {client!r} seq {seq} "
                        f"<= previous {prev} (dedup stream must be "
                        "strictly monotonic)"
                    )
                last_seq_per_client[client] = seq
    report["last_version"] = last_version
    report["clients"] = len(last_seq_per_client)
    if checkpoint_dir:
        from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver

        tip = None
        if os.path.isdir(checkpoint_dir):
            tip = CheckpointSaver(
                checkpoint_dir
            ).get_valid_latest_version()
        report["checkpoint_tip"] = tip
        if report["first_version"] is not None:
            tip_v = int(tip or 0)
            report["covered_by_checkpoint"] = min(
                report["records"],
                max(0, tip_v - report["first_version"] + 1),
            )
            if report["first_version"] > tip_v + 1:
                errors.append(
                    f"{path}: coverage gap — log starts at version "
                    f"{report['first_version']} but the newest "
                    f"durable checkpoint covers only <= {tip_v}; "
                    f"versions {tip_v + 1}..."
                    f"{report['first_version'] - 1} are in neither "
                    "the chain nor the log (truncation ran ahead of "
                    "checkpoint publish?)"
                )
            for before, after in report["version_gaps"]:
                if after - 1 > tip_v:
                    errors.append(
                        f"{path}: uncovered version gap — records "
                        f"jump v{before} -> v{after} but the newest "
                        f"durable checkpoint covers only <= {tip_v}; "
                        f"versions {before + 1}...{after - 1} are in "
                        "neither the chain nor the log"
                    )
        elif tip is None and report["records"] == 0:
            # Empty log + no checkpoint = a fresh shard; fine.
            report["covered_by_checkpoint"] = 0
    return errors, report


def check_pushlog(path: str,
                  checkpoint_dir: Optional[str] = None
                  ) -> Tuple[List[str], dict]:
    """Audit one log dir, or every log under a tree. When no
    ``checkpoint_dir`` is given and a log dir has a sibling ``ckpt``/
    ``rows`` checkpoint layout, coverage is still only checked when
    the caller names it explicitly (tree layouts vary)."""
    logs = find_logs(path)
    if not logs:
        return ([f"no push logs found under {path}"],
                {"logs": [], "records": 0})
    all_errors: List[str] = []
    reports = []
    for log in logs:
        errors, report = check_one_log(log, checkpoint_dir)
        all_errors += errors
        reports.append(report)
    return all_errors, {
        "logs": reports,
        "records": sum(r["records"] for r in reports),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("check_pushlog")
    parser.add_argument("path", help="one push-log dir or a tree")
    parser.add_argument("--checkpoint", default="",
                        help="checkpoint dir to verify coverage "
                             "against (chain tip vs log head)")
    args = parser.parse_args(argv)
    errors, report = check_pushlog(
        args.path, args.checkpoint or None
    )
    for log in report.get("logs", []):
        line = (
            f"{log['path']}: {log['segments']} segment(s), "
            f"{log['records']} record(s)"
        )
        if log["first_version"] is not None:
            line += (
                f", versions {log['first_version']}.."
                f"{log['last_version']}"
            )
        if log.get("torn_tail"):
            line += f", torn tail ({log['torn_tail']})"
        print(line)
    if errors:
        print(f"FAIL: {len(errors)} error(s)")
        for err in errors:
            print(f"  - {err}")
        return 1
    print(f"OK: {report['records']} record(s) across "
          f"{len(report.get('logs', []))} log(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
