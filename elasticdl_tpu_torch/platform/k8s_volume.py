"""Volume-string parsing (port of elasticdl_tpu/platform/k8s_volume.py;
reference common/k8s_volume.py).

``"claim_name=pvc0,mount_path=/data;host_path=/tmp/x,mount_path=/x"``
→ (volumes, volume_mounts) manifest fragments. Each ``;``-separated group
is one volume: either a PVC (``claim_name``) or a host path
(``host_path``), always with a ``mount_path``; ``sub_path`` optional.
"""

_ALLOWED_KEYS = {"claim_name", "host_path", "mount_path", "sub_path",
                 "type"}


def parse_volume(volume_str: str):
    """Returns (volumes, volume_mounts) lists of manifest dicts."""
    volumes, mounts = [], []
    if not volume_str:
        return volumes, mounts
    for i, group in enumerate(v for v in volume_str.split(";") if v.strip()):
        kv = {}
        for entry in group.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise ValueError(
                    f"Malformed volume entry {entry!r}; expected k=v"
                )
            key, _, value = entry.partition("=")
            key = key.strip()
            if key not in _ALLOWED_KEYS:
                raise ValueError(
                    f"Unknown volume key {key!r}; expected {_ALLOWED_KEYS}"
                )
            kv[key] = value.strip()
        if "mount_path" not in kv:
            raise ValueError(f"Volume group {group!r} missing mount_path")
        has_claim = "claim_name" in kv
        has_host = "host_path" in kv
        if has_claim == has_host:
            raise ValueError(
                f"Volume group {group!r} needs exactly one of "
                "claim_name / host_path"
            )
        name = f"volume-{i}"
        if has_claim:
            volumes.append({
                "name": name,
                "persistentVolumeClaim": {"claimName": kv["claim_name"]},
            })
        else:
            host = {"path": kv["host_path"]}
            if kv.get("type"):
                host["type"] = kv["type"]
            volumes.append({"name": name, "hostPath": host})
        mount = {"name": name, "mountPath": kv["mount_path"]}
        if kv.get("sub_path"):
            mount["subPath"] = kv["sub_path"]
        mounts.append(mount)
    return volumes, mounts
