"""Fsck for a checkpoint directory
(``elasticdl_tpu_torch/checkpoint/saver.py``), the port's copy of
``tools/check_checkpoint.py``: the same checks, messages and exit codes
(0 clean, 1 errors, 2 usage). It reads either package's checkpoints
(the shard files are the same bytes).

Usage::

    python -m elasticdl_tpu_torch.tools.check_checkpoint CHECKPOINT_DIR

Validates (returning a list of human-readable errors, empty = pass):

- **shard framing**: every shard file's CRC32 frame verifies and the
  payload decodes + passes the structural check
  (``validate_shard_payload``); legacy unframed files are decoded too;
- **slowest-shard-wins validity**: within one element dir, every file
  records the same ``num_shards`` and the file count matches it;
- **meta consistency**: each file's recorded version/shard match its
  name and dir; delta files' ``base``/``prev`` match ``chain.json``;
- **chain consistency**: every delta's ``prev`` linkage resolves
  (base → d1 → d2 → …), versions strictly increase along a chain, and
  a delta's base exists;
- the directory holds at least one restorable state.

**Reclaimable garbage** — orphaned deltas (base missing / broken
linkage), leftover ``.tmp`` publish dirs, count-invalid elements — is
*reported* with its byte size but is not an error: the saver's GC and
validity scan already ignore it; fsck's job is to surface what can be
reclaimed and what a crash left behind.

Stdlib + framework-serde only, importable from tests
(``check_checkpoint(path)``).
"""

import os
import sys
from typing import List, Tuple


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for fname in files:
            try:
                total += os.path.getsize(os.path.join(root, fname))
            except OSError:
                pass
    return total


def _check_element(vdir: str, version: int, shard_re,
                   expect_chain: bool) -> Tuple[List[str], dict]:
    """Validate one element dir. Returns (errors, info) where info has
    num_shards and (for deltas) base/prev from chain.json."""
    from elasticdl_tpu_torch.checkpoint.saver import CHAIN_FILE
    from elasticdl_tpu_torch.checkpoint.state_io import (
        CorruptCheckpointError,
        unframe_shard_blob,
        validate_shard_payload,
    )
    from elasticdl_tpu_torch.common import tensor_utils

    errors: List[str] = []
    info = {"num_shards": None, "base": None, "prev": None}
    name = os.path.basename(vdir)
    chain = None
    if expect_chain:
        import json

        chain_path = os.path.join(vdir, CHAIN_FILE)
        try:
            with open(chain_path) as f:
                chain = json.load(f)
        except (OSError, ValueError) as exc:
            errors.append(f"{name}: unreadable {CHAIN_FILE}: {exc}")
        if chain is not None:
            if int(chain.get("version", -1)) != version:
                errors.append(
                    f"{name}: {CHAIN_FILE} names version "
                    f"{chain.get('version')} but the dir is {version}"
                )
            info["base"] = chain.get("base")
            info["prev"] = chain.get("prev")
    shards = sorted(f for f in os.listdir(vdir) if shard_re.match(f))
    if not shards:
        errors.append(f"{name}: no shard files")
        return errors, info
    counts = {int(shard_re.match(f).group(2)) for f in shards}
    if len(counts) != 1:
        errors.append(
            f"{name}: mixed num_shards among files ({sorted(counts)})"
        )
    else:
        n = counts.pop()
        info["num_shards"] = n
        if n != len(shards):
            errors.append(
                f"{name}: {len(shards)} shard file(s) but each "
                f"records num_shards={n} (slowest-shard-wins: "
                "incomplete element)"
            )
    seen_shards = set()
    for fname in shards:
        path = os.path.join(vdir, fname)
        shard_idx = int(shard_re.match(fname).group(1))
        if shard_idx in seen_shards:
            errors.append(f"{name}/{fname}: duplicate shard index")
        seen_shards.add(shard_idx)
        try:
            with open(path, "rb") as f:
                payload = tensor_utils.loads(
                    unframe_shard_blob(f.read(), path)
                )
            validate_shard_payload(payload, path)
        except CorruptCheckpointError as exc:
            errors.append(f"{name}/{fname}: {exc}")
            continue
        except Exception as exc:
            errors.append(
                f"{name}/{fname}: cannot decode "
                f"({type(exc).__name__}: {exc})"
            )
            continue
        meta = payload["meta"]
        if meta["version"] != version:
            errors.append(
                f"{name}/{fname}: meta.version {meta['version']} != "
                f"dir version {version}"
            )
        if meta["shard"] != shard_idx:
            errors.append(
                f"{name}/{fname}: meta.shard {meta['shard']} != "
                f"file shard {shard_idx}"
            )
        if chain is not None:
            for key in ("base", "prev"):
                if meta.get(key) != chain.get(key):
                    errors.append(
                        f"{name}/{fname}: meta.{key} {meta.get(key)} "
                        f"!= {CHAIN_FILE} {key} {chain.get(key)}"
                    )
    return errors, info


def check_checkpoint(path: str) -> Tuple[List[str], dict]:
    """Audit one checkpoint dir. Returns (errors, report); the report
    carries chains / garbage / reclaimable-bytes details."""
    from elasticdl_tpu_torch.checkpoint.saver import (
        _DELTA_RE,
        _DELTA_SHARD_RE,
        _SHARD_RE,
        _VERSION_RE,
        CheckpointSaver,
    )

    report = {
        "chains": [], "garbage": [], "reclaimable_bytes": 0,
        "elements_checked": 0,
    }
    if not os.path.isdir(path):
        return [f"{path}: no such checkpoint directory"], report
    saver = CheckpointSaver(path)
    errors: List[str] = []

    def garbage(entry: str, why: str):
        full = os.path.join(path, entry)
        size = _dir_bytes(full)
        report["garbage"].append(
            {"dir": entry, "why": why, "bytes": size}
        )
        report["reclaimable_bytes"] += size

    bases, deltas = {}, {}
    for entry in sorted(os.listdir(path)):
        full = os.path.join(path, entry)
        if entry.endswith(".tmp") and os.path.isdir(full):
            garbage(entry, "unpublished tmp dir (crash mid-write)")
            continue
        m = _VERSION_RE.match(entry)
        if m and os.path.isdir(full):
            version = int(m.group(1))
            errs, info = _check_element(
                full, version, _SHARD_RE, expect_chain=False
            )
            errors.extend(errs)
            report["elements_checked"] += 1
            if errs:
                garbage(entry, "invalid/corrupt base")
            else:
                bases[version] = info
            continue
        m = _DELTA_RE.match(entry)
        if m and os.path.isdir(full):
            version = int(m.group(1))
            errs, info = _check_element(
                full, version, _DELTA_SHARD_RE, expect_chain=True
            )
            errors.extend(errs)
            report["elements_checked"] += 1
            if errs:
                garbage(entry, "invalid/corrupt delta")
            else:
                deltas[version] = info
            continue
    # Chain consistency over the intact elements: every delta must be
    # reachable from its base through prev links.
    reachable = set()
    for base in sorted(bases):
        chain = {"base": base, "deltas": []}
        prev = base
        for d in sorted(v for v, i in deltas.items()
                        if i["base"] == base):
            if d <= prev:
                errors.append(
                    f"delta-{d}: version not past its predecessor "
                    f"{prev} (chain of base {base})"
                )
                break
            if deltas[d]["prev"] != prev:
                # Not an error per se — restore stops at the gap — but
                # everything past it is unrestorable garbage.
                break
            chain["deltas"].append(d)
            reachable.add(d)
            prev = d
        report["chains"].append(chain)
    for d in sorted(deltas):
        if d in reachable:
            continue
        info = deltas[d]
        if info["base"] not in bases:
            garbage(f"delta-{d}",
                    f"orphaned delta (base {info['base']} missing)")
        else:
            garbage(f"delta-{d}",
                    f"unreachable delta (prev {info['prev']} broke "
                    "the chain)")
    if saver.get_valid_latest_version() is None and not bases:
        errors.append(f"{path}: no restorable checkpoint state")
    return errors, report


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: check_checkpoint.py CHECKPOINT_DIR",
              file=sys.stderr)
        return 2
    errors, report = check_checkpoint(argv[0])
    for chain in report["chains"]:
        deltas = chain["deltas"]
        print(f"chain: base {chain['base']}"
              + (f" + deltas {deltas}" if deltas else " (no deltas)"))
    for item in report["garbage"]:
        print(f"reclaimable: {item['dir']} ({item['bytes']} B) — "
              f"{item['why']}")
    if report["reclaimable_bytes"]:
        print(f"reclaimable total: {report['reclaimable_bytes']} B")
    if errors:
        for err in errors:
            print(f"check_checkpoint: {err}", file=sys.stderr)
        print(f"{argv[0]}: FAILED ({len(errors)} error(s))",
              file=sys.stderr)
        return 1
    print(f"{argv[0]}: OK ({report['elements_checked']} element(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
