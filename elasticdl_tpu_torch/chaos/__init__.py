"""The port's chaos plane (port of elasticdl_tpu/chaos/): drills that
kill parts of the system mid-protocol and hold what recovers to a
fault-free twin.

Ported so far: ``reshard_drill`` (the row service's live resharding),
``failover_drill`` (the master's hot standby against
restart-and-replay), ``sched_drill`` (two jobs on one fleet across a
priority preemption), ``stream_drill`` (a worker, a row shard and the
master killed in one window mid-stream, and a stream tenant preempted
by a batch job) and ``quake_drill``'s fleet helpers (its ``serve``
command only). The fault plans, interceptors, invariants, the quake
drill's scenarios and the other drills are ROADMAP Queue 1, item 8g.
"""
