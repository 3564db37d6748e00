"""The port's chaos plane (port of elasticdl_tpu/chaos/): deterministic
fault injection, recovery invariants, and drills that kill parts of the
system mid-protocol and hold what recovers to a fault-free twin.

``faults`` (seed-deterministic schedules), ``interceptors`` (injection
hooks threaded through RPC, checkpointing, the push log, the instance
manager and the in-process cluster), ``invariants`` (exactly-once task
accounting, row conservation, checkpoint monotonicity, master-restart
and loss-trajectory equivalence) and ``runner`` (the harness and
``python -m elasticdl_tpu_torch chaos``). The drills: ``reshard_drill``,
``failover_drill``, ``sched_drill``, ``stream_drill``, ``quake_drill``,
``tiered_drill``, ``usage_drill``, ``brownout_drill``, ``slo_drill``,
``profile_drill``, ``serving_drill``, ``probe_drill`` and
``autoscale_drill``.
"""

from elasticdl_tpu_torch.chaos.faults import (  # noqa: F401
    FaultEvent,
    FaultPlan,
    default_plan,
    master_kill_plan,
    randomized_plan,
)
from elasticdl_tpu_torch.chaos.interceptors import (  # noqa: F401
    ChaosKill,
    FaultInjector,
)
from elasticdl_tpu_torch.chaos.invariants import (  # noqa: F401
    CheckpointMonotonicity,
    CheckResult,
    ExactlyOnceTaskAccounting,
    LossTrajectoryEquivalence,
    MasterRestartEquivalence,
    RowConservation,
)
from elasticdl_tpu_torch.chaos.runner import ChaosRunner  # noqa: F401
