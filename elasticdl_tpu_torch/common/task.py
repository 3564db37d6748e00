"""Task: one shard range of one file, the unit of dynamic data sharding
(port of elasticdl_tpu/common/task.py). ``to_dict``/``from_dict`` are
its form on the wire."""

from dataclasses import dataclass, field


@dataclass
class Task:
    task_id: int = -1
    shard_name: str = ""
    start: int = 0
    end: int = 0
    type: str = "training"
    model_version: int = -1
    extended_config: dict = field(default_factory=dict)

    @property
    def num_records(self) -> int:
        return self.end - self.start

    def to_dict(self) -> dict:
        return {
            "task_id": self.task_id,
            "shard_name": self.shard_name,
            "start": self.start,
            "end": self.end,
            "type": self.type,
            "model_version": self.model_version,
            "extended_config": self.extended_config,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Task":
        return cls(**d)
