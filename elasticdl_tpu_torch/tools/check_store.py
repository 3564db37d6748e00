"""Fsck for cold-tier segment stores
(``elasticdl_tpu_torch/storage/cold_store.py``), the port's copy of
``tools/check_store.py``: the same checks, report fields and exit codes
(0 clean, 1 errors, 2 usage). It reads either package's stores (the
bytes are the same).

Usage::

    python -m elasticdl_tpu_torch.tools.check_store COLD_DIR

``COLD_DIR`` is either one store (a dir holding ``MANIFEST.json`` +
``segment-*.seg``) or a tree of them (the ``cold_dir/<table>/<member>``
layout ``tier_host_tables`` builds): every store found underneath is
audited.

Validates per store (returning human-readable errors, empty = pass):

- **framing/CRC per segment**: every record is length-prefixed,
  ``EDLC1``-framed, CRC-verified, and exactly ``record_bytes`` long for
  the manifest's dim. A torn TAIL on the newest segment is *reported*
  (a crashed process's last append — recovery truncates it), a tear
  anywhere else is an error;
- **index-vs-segment consistency**: when the clean-close index
  snapshot (``index.json``) exists, every index entry must resolve to
  an intact record holding that id at that offset — a divergence means
  reads serve the wrong bytes. Replay-live ids ABSENT from the
  snapshot are dropped rows (``drop_rows`` writes no tombstone;
  recovery honors the snapshot), counted as garbage;
- **live-fraction / garbage accounting**: per segment, records vs
  later-record-wins live count; superseded records are reclaimable
  garbage (compaction's input), reported with byte sizes.

Importable from tests (``check_store(path)``).
"""

import json
import os
import sys
from typing import List, Tuple

def find_stores(path: str) -> List[str]:
    """Every cold-store dir (holds MANIFEST.json) under ``path``."""
    out = []
    for root, _dirs, files in os.walk(path):
        if "MANIFEST.json" in files:
            out.append(root)
    return sorted(out)


def check_one_store(path: str) -> Tuple[List[str], dict]:
    """Audit one cold-store dir. Returns (errors, report)."""
    from elasticdl_tpu_torch.storage.cold_store import (
        ColdRowStore,
        ColdStoreError,
        INDEX_SNAPSHOT_FILE,
        record_bytes,
    )

    errors: List[str] = []
    report = {
        "store": path, "segments": {}, "live_rows": 0,
        "garbage_records": 0, "garbage_bytes": 0, "torn_tail": None,
        "index_snapshot": False,
    }
    try:
        manifest = ColdRowStore.read_manifest(path)
        dim = int(manifest["dim"])
    except (OSError, ValueError, KeyError) as exc:
        return [f"{path}: unreadable manifest: {exc}"], report
    rec_len = record_bytes(dim)
    if manifest.get("record_bytes") not in (None, rec_len):
        errors.append(
            f"{path}: manifest record_bytes {manifest['record_bytes']}"
            f" != {rec_len} computed from dim {dim}"
        )
    segs = ColdRowStore.list_segments(path)
    # Later-record-wins replay across segments in order — the same
    # walk ColdRowStore._recover does, so fsck's live view IS the view
    # a relaunched store would rebuild.
    index = {}
    seg_records = {}
    for seg in segs:
        newest = seg == segs[-1]
        try:
            records, torn = ColdRowStore.scan_segment(
                path, seg, rec_len, allow_torn_tail=newest
            )
        except ColdStoreError as exc:
            errors.append(str(exc))
            continue
        if torn:
            report["torn_tail"] = {
                "segment": seg, "intact_records": len(records),
            }
        seg_records[seg] = len(records)
        for row_id, offset in records:
            index[row_id] = (seg, offset)
    seg_live = {seg: 0 for seg in seg_records}
    for seg, _offset in index.values():
        seg_live[seg] += 1
    for seg in segs:
        if seg not in seg_records:
            continue
        records = seg_records[seg]
        live = seg_live.get(seg, 0)
        report["segments"][seg] = {
            "records": records, "live": live,
            "garbage": records - live,
        }
        report["garbage_records"] += records - live
    report["garbage_bytes"] = report["garbage_records"] * rec_len
    report["live_rows"] = len(index)
    # Index snapshot (only a cleanly closed store writes one): it must
    # agree with the segments exactly — both directions.
    snap_path = os.path.join(path, INDEX_SNAPSHOT_FILE)
    if os.path.exists(snap_path):
        report["index_snapshot"] = True
        try:
            with open(snap_path) as f:
                snap = {
                    int(k): (int(v[0]), int(v[1]))
                    for k, v in json.load(f)["index"].items()
                }
        except (OSError, ValueError, KeyError) as exc:
            errors.append(f"{path}: unreadable index snapshot: {exc}")
            snap = None
        if snap is not None:
            for row_id, (seg, offset) in sorted(snap.items()):
                have = index.get(row_id)
                if have is None:
                    errors.append(
                        f"{path}: index names id {row_id} at segment "
                        f"{seg}@{offset} but no segment holds it"
                    )
                elif have != (seg, offset):
                    errors.append(
                        f"{path}: index places id {row_id} at "
                        f"{(seg, offset)} but later-record-wins replay "
                        f"places it at {have}"
                    )
            extra = sorted(set(index) - set(snap))
            if extra:
                # Replay-live ids absent from a clean close's snapshot
                # are DROPPED rows (drop_rows writes no tombstone; the
                # recovery path honors the snapshot, so nothing
                # resurrects): reclaimable garbage, not corruption.
                for row_id in extra:
                    seg, _offset = index.pop(row_id)
                    report["segments"][seg]["live"] -= 1
                    report["segments"][seg]["garbage"] += 1
                report["garbage_records"] += len(extra)
                report["garbage_bytes"] = (
                    report["garbage_records"] * rec_len
                )
                report["live_rows"] = len(index)
    return errors, report


def check_store(path: str) -> Tuple[List[str], dict]:
    """Audit every cold store under ``path``."""
    report = {"stores": [], "garbage_bytes": 0, "live_rows": 0}
    if not os.path.isdir(path):
        return [f"{path}: no such directory"], report
    stores = find_stores(path)
    if not stores:
        return [f"{path}: no cold stores (no MANIFEST.json) found"], report
    errors: List[str] = []
    for store in stores:
        errs, rep = check_one_store(store)
        errors.extend(errs)
        report["stores"].append(rep)
        report["garbage_bytes"] += rep["garbage_bytes"]
        report["live_rows"] += rep["live_rows"]
    return errors, report


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: python -m elasticdl_tpu_torch.tools.check_store "
              "COLD_DIR", file=sys.stderr)
        return 2
    errors, report = check_store(argv[0])
    for rep in report["stores"]:
        bits = [
            f"{rep['store']}: {rep['live_rows']} live row(s) across "
            f"{len(rep['segments'])} segment(s)"
        ]
        if rep["garbage_records"]:
            bits.append(
                f"{rep['garbage_records']} reclaimable record(s) "
                f"({rep['garbage_bytes']} B)"
            )
        if rep["torn_tail"] is not None:
            bits.append(
                f"torn tail on segment {rep['torn_tail']['segment']} "
                "(crash-truncated on next open)"
            )
        print("; ".join(bits))
    if errors:
        for err in errors:
            print(f"check_store: {err}", file=sys.stderr)
        print(f"{argv[0]}: FAILED ({len(errors)} error(s))",
              file=sys.stderr)
        return 1
    print(f"{argv[0]}: OK ({len(report['stores'])} store(s), "
          f"{report['live_rows']} live row(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
