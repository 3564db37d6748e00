"""The port's chaos plane (port of elasticdl_tpu/chaos/): drills that
kill parts of the system mid-protocol and hold what recovers to a
fault-free twin.

Ported so far: ``reshard_drill`` (the row service's live resharding)
and ``failover_drill`` (the master's hot standby against
restart-and-replay). The fault plans, interceptors, invariants and the
other drills are ROADMAP Queue 1, item 8g.
"""
