"""The port's task dispatcher (``elasticdl_tpu_torch/master/
task_dispatcher.py``) against the JAX package's: the same scripted
get/report sequences through both must hand out the same tasks (ids,
shards, ranges, types, versions), take the same re-queue decisions and
end with the same counters and exported state. The port's worker then
trains the same batches in the same order as a JAX worker would.
"""

import pytest

from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JaxDispatcher,
)
from elasticdl_tpu_torch.common.constants import MAX_TASK_RETRIES, TaskType
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher


def _task(t):
    if t is None:
        return None
    return (t.task_id, t.shard_name, t.start, t.end, t.type,
            t.model_version, dict(t.extended_config))


def _run(cls, config, script):
    """Drive one dispatcher through ``script``; return every outcome."""
    d = cls(**config["init"])
    if config.get("train_end"):
        d.add_deferred_callback(d.create_train_end_callback_task)
    if config.get("max_steps"):
        d.set_max_steps(*config["max_steps"])
    leased = []   # task ids handed out, in order
    out = []
    for op in script:
        kind = op[0]
        if kind == "get":
            task = d.get(op[1])
            if task is not None:
                leased.append(task.task_id)
            out.append(("get", _task(task)))
        elif kind == "report":
            # op[1]: an index into the leased ids (negative from the
            # end) or an explicit id ("id", n).
            tid = op[1][1] if isinstance(op[1], tuple) else leased[op[1]]
            task, wid, requeued, dup = d.apply_report(tid, op[2], op[3])
            out.append(("report", tid, _task(task), wid, requeued, dup))
        elif kind == "eval":
            d.create_tasks(TaskType.EVALUATION, op[1])
        elif kind == "recover":
            d.recover_tasks(op[1])
        elif kind == "drain":
            while True:
                task = d.get(op[1])
                if task is None:
                    break
                out.append(("get", _task(task)))
                out.append(("report",) + d.report(task.task_id, True)[1:])
        out.append(("state", d.finished(), d.queue_depths(),
                    d.count_tasks(TaskType.TRAINING),
                    d.count_tasks(TaskType.EVALUATION)))
    state = d.export_state()
    out.append(("counters", dict(d.counters.total_records),
                dict(d.counters.failed_records)))
    out.append(("export", state))
    return out


SHARDS = {"a.rec": (0, 100), "b.rec": (0, 37)}
CASES = {
    "failures": (
        dict(init=dict(training_shards=SHARDS, records_per_task=16,
                       shuffle=False)),
        [("get", 0), ("get", 0), ("report", 0, False, "ValueError: x"),
         ("get", 1), ("report", 1, True, ""), ("report", 2, True, ""),
         ("drain", 0)],
    ),
    "retry_cap": (
        dict(init=dict(training_shards={"a.rec": (0, 8)},
                       records_per_task=8, shuffle=False)),
        [op for _ in range(MAX_TASK_RETRIES + 1)
         for op in (("get", 0), ("report", -1, False, "boom"))]
        + [("get", 0), ("drain", 0)],
    ),
    "epochs": (
        dict(init=dict(training_shards=SHARDS, records_per_task=32,
                       num_epochs=3, shuffle=False)),
        [("drain", 0)],
    ),
    "seeded_shuffle": (
        dict(init=dict(training_shards=SHARDS, records_per_task=8,
                       num_epochs=2, shuffle=True, seed=7)),
        [("get", 0), ("report", 0, False, "x"), ("drain", 1)],
    ),
    "eval_jumps_the_queue": (
        dict(init=dict(training_shards=SHARDS,
                       evaluation_shards={"e.rec": (0, 40)},
                       records_per_task=16, shuffle=False)),
        [("get", 0), ("report", 0, True, ""), ("eval", 3), ("get", 0),
         ("get", 1), ("report", 1, False, "y"), ("drain", 0)],
    ),
    "recover_tasks": (
        dict(init=dict(training_shards=SHARDS, records_per_task=16,
                       shuffle=False)),
        [("get", 0), ("get", 1), ("get", 1), ("get", 0), ("recover", 1),
         ("get", 2), ("report", 0, True, ""), ("drain", 2)],
    ),
    "duplicate_and_unknown_reports": (
        dict(init=dict(training_shards=SHARDS, records_per_task=50,
                       shuffle=False)),
        [("get", 0), ("report", 0, True, ""), ("report", 0, True, ""),
         ("report", ("id", 999), True, ""), ("get", 0),
         ("report", 1, False, "z"), ("report", 1, False, "z"),
         ("drain", 0)],
    ),
    "train_end_callback": (
        dict(init=dict(training_shards={"a.rec": (0, 40)},
                       records_per_task=16, num_epochs=2, shuffle=False),
             train_end=True),
        [("drain", 0), ("get", 0)],
    ),
    "max_steps_and_preemption": (
        dict(init=dict(training_shards=SHARDS, records_per_task=16,
                       num_epochs=2, shuffle=True, seed=3),
             max_steps=(9, 4), train_end=True),
        [("get", 0), ("report", 0, False, "preempted (SIGTERM)"),
         ("get", 0), ("report", 1, False, "preempted (SIGTERM)"),
         ("drain", 0), ("get", 0)],
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dispatchers_hand_out_the_same_tasks(name):
    config, script = CASES[name]
    got = _run(TaskDispatcher, config, script)
    want = _run(JaxDispatcher, config, script)
    assert got == want
    # The scripts do reach what they are named for.
    if name == "retry_cap":
        assert got[-2][2] == {TaskType.TRAINING: 8}
    if name == "train_end_callback":
        assert any(o[0] == "get" and o[1] is not None
                   and o[1][4] == TaskType.TRAIN_END_CALLBACK for o in got)
    if name == "eval_jumps_the_queue":
        gets = [o[1] for o in got if o[0] == "get" and o[1] is not None]
        assert gets[1][4] == TaskType.EVALUATION and gets[1][5] == 3
