"""Resource-string parsing (port of elasticdl_tpu/platform/k8s_resource.py;
reference common/k8s_resource.py).

``"cpu=1,memory=4096Mi,tpu=8"`` → the ``resources`` fragment of a k8s
container manifest. Parsing is pure and validated here; no kubernetes
client objects, so manifests render identically with or without the
``kubernetes`` package installed.
"""

import re

# k8s quantity: integer/decimal with optional binary/decimal suffix.
_QUANTITY_RE = re.compile(r"^[0-9]+(\.[0-9]+)?(m|[EPTGMK]i?)?$")

# Accepted resource names; tpu maps to the TPU device-plugin resource.
_RESOURCE_NAME_MAP = {
    "cpu": "cpu",
    "memory": "memory",
    "disk": "ephemeral-storage",
    "ephemeral-storage": "ephemeral-storage",
    "gpu": "nvidia.com/gpu",
    "tpu": "google.com/tpu",
}


def parse_resource(resource_str: str) -> dict:
    """Parse ``k=v,...`` into a dict of k8s resource quantities."""
    out = {}
    if not resource_str:
        return out
    for kv in resource_str.split(","):
        kv = kv.strip()
        if not kv:
            continue
        if "=" not in kv:
            raise ValueError(
                f"Malformed resource entry {kv!r}; expected name=quantity"
            )
        name, _, quantity = kv.partition("=")
        name = name.strip().lower()
        quantity = quantity.strip()
        if name not in _RESOURCE_NAME_MAP:
            raise ValueError(
                f"Unknown resource {name!r}; expected one of "
                f"{sorted(_RESOURCE_NAME_MAP)}"
            )
        if not _QUANTITY_RE.match(quantity):
            raise ValueError(f"Invalid quantity {quantity!r} for {name}")
        out[_RESOURCE_NAME_MAP[name]] = quantity
    return out


def resource_requirements(request_str: str, limit_str: str = "") -> dict:
    """Build the ``resources`` manifest fragment; limits default to
    requests when unset (reference k8s_resource.py behavior)."""
    requests = parse_resource(request_str)
    limits = parse_resource(limit_str) if limit_str else dict(requests)
    frag = {}
    if requests:
        frag["requests"] = requests
    if limits:
        frag["limits"] = limits
    return frag
