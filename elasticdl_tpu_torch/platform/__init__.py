"""The k8s platform plane of the port: resource and volume parsing, pod
and service manifests, the gated ``kubernetes`` client and the job
monitor (``elasticdl_tpu/platform`` line for line)."""
