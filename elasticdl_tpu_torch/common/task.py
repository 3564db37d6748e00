"""Task: one shard range of one file, the unit of data sharding (port of
elasticdl_tpu/common/task.py, without the wire conversions the master
and worker use)."""

from dataclasses import dataclass


@dataclass
class Task:
    task_id: int = -1
    shard_name: str = ""
    start: int = 0
    end: int = 0
    type: str = "training"
    model_version: int = -1

    @property
    def num_records(self) -> int:
        return self.end - self.start
