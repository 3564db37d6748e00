"""The stream-watermark helpers of the master's write-ahead journal
(the part of elasticdl_tpu/master/journal.py that the task dispatcher
imports, copied). The journal itself, its records and
``recover_master_state`` wait for the master's recovery (ROADMAP Queue
1, item 8).
"""


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
