"""Fsck for the shard-map authority's state file
(``elasticdl_tpu_torch/master/row_reshard.py``), the port's copy of
``tools/check_reshard.py``: the same checks, report fields and exit
codes (0 clean, 1 errors). It reads either package's state files (the
bytes are the same).

Usage::

    python -m elasticdl_tpu_torch.tools.check_reshard STATE_PATH \
        [--probe ADDR,ADDR,...]

Checks:

- the state JSON parses and the map passes the whole ``ShardMap``
  validation (ranges sorted, disjoint and covering, shard indices in
  bounds, version >= 1);
- an in-flight migration record (a half-moved range) is found and is
  structurally resumable: a known phase, source and target inside the
  fleet, a well-formed bucket range, and ownership consistent with the
  phase ("copy": the map still gives the range to the source, the flip
  has not happened; "cutover": the persisted map already gives it to
  the target, only the distribution remains);
- with ``--probe`` each live shard's installed epoch is held to the
  authority's: a shard ahead of the state file means someone else wrote
  epochs (split brain, an error); a shard behind with no migration in
  flight means a lost sync, which the next ``resume()`` or ``sync()``
  repairs (reported, not an error).

Importable: ``check_reshard(state_path, probe_addrs=None)``.
"""

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

PHASES = ("copy", "cutover")


def check_reshard(state_path: str,
                  probe_addrs: Optional[List[str]] = None
                  ) -> Tuple[List[str], dict]:
    from elasticdl_tpu_torch.embedding.shard_map import (
        NUM_BUCKETS,
        ShardMap,
        ShardMapError,
    )

    errors: List[str] = []
    report = {
        "state_path": state_path,
        "map_version": 0,
        "num_shards": 0,
        "migration_in_flight": False,
        "resumable": False,
        "shards_probed": 0,
        "shards_behind": [],
    }
    if not os.path.exists(state_path):
        return [f"{state_path}: no authority state file"], report
    try:
        with open(state_path) as fh:
            state = json.load(fh)
    except Exception as exc:
        return [f"{state_path}: unreadable ({exc})"], report
    try:
        smap = ShardMap.from_json(state["map"])
    except (KeyError, ShardMapError, TypeError) as exc:
        return [f"{state_path}: invalid map ({exc})"], report
    report["map_version"] = smap.version
    report["num_shards"] = len(smap.shards)

    mig = state.get("migration")
    if mig is not None:
        report["migration_in_flight"] = True
        resumable = True
        phase = mig.get("phase")
        if phase not in PHASES:
            errors.append(f"migration phase {phase!r} unknown")
            resumable = False
        for key in ("source", "target"):
            s = mig.get(key)
            if not isinstance(s, int) or not 0 <= s < len(smap.shards):
                errors.append(f"migration {key} {s!r} outside fleet")
                resumable = False
        lo, hi = mig.get("lo"), mig.get("hi")
        if not (isinstance(lo, int) and isinstance(hi, int)
                and 0 <= lo < hi <= NUM_BUCKETS):
            errors.append(f"migration range ({lo!r}, {hi!r}) malformed")
            resumable = False
        if resumable:
            owners = set(
                int(s) for s in smap.owner_table[lo:hi].tolist()
            )
            if phase == "copy" and owners != {int(mig["source"])}:
                errors.append(
                    f"phase=copy but buckets [{lo}, {hi}) owned by "
                    f"{sorted(owners)}, not source {mig['source']} — "
                    "the flip happened without the record advancing"
                )
                resumable = False
            if phase == "cutover" and owners != {int(mig["target"])}:
                errors.append(
                    f"phase=cutover but buckets [{lo}, {hi}) owned by "
                    f"{sorted(owners)}, not target {mig['target']} — "
                    "the persisted map predates the flip"
                )
                resumable = False
        report["resumable"] = resumable

    for addr in probe_addrs or []:
        from elasticdl_tpu_torch.comm.rpc import RpcError, RpcStub

        stub = RpcStub(addr, "RowService", max_retries=1)
        try:
            resp = stub.call("get_shard_map")
        except RpcError as exc:
            errors.append(f"probe {addr}: unreachable ({exc.code})")
            continue
        finally:
            stub.close()
        report["shards_probed"] += 1
        installed = resp.get("map") or {}
        version = int(installed.get("version", 0))
        if version > smap.version:
            errors.append(
                f"probe {addr}: installed epoch v{version} is AHEAD "
                f"of the authority's v{smap.version} (split-brain?)"
            )
        elif version < smap.version and mig is None:
            # Lost sync, self-healing via resume()/REDIRECT — surface
            # it without failing the audit.
            report["shards_behind"].append(addr)
    return errors, report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("check_reshard")
    parser.add_argument("state_path")
    parser.add_argument("--probe", default="",
                        help="Comma list of shard addrs to compare "
                             "installed epochs against the state file")
    args = parser.parse_args(argv)
    probe = [a.strip() for a in args.probe.split(",") if a.strip()]
    errors, report = check_reshard(args.state_path, probe or None)
    print(json.dumps(report, indent=2, sort_keys=True))
    for err in errors:
        print(f"ERROR: {err}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
