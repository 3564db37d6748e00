"""Constants the port needs from elasticdl_tpu/common/constants.py
(same names and values)."""


class GRPC:
    # Tiny control messages (tasks, versions, metrics); the 256MB cap
    # covers the raw eval outputs a worker reports.
    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024


class TaskType:
    """Task types dispatched by the master (reference
    elasticdl.proto:24-30)."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    TRAIN_END_CALLBACK = "train_end_callback"


class Mode:
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


class DistributionStrategy:
    LOCAL = "Local"
    MESH = "MeshStrategy"
    # Kept as an alias for reference-API compatibility.
    PARAMETER_SERVER = "ParameterServerStrategy"
    ALLREDUCE = "AllreduceStrategy"


class ReaderType:
    CSV = "CSV"
    RECORD_FILE = "RecordFile"
    TEXT = "Text"
    TABLE = "Table"  # row-range table service (not ported yet)
    STREAM = "Stream"  # append-only record stream (not ported yet)


MAX_TASK_RETRIES = 3
MAX_MINIBATCH_RETRY_NUM = 64

DEFAULT_TASK_TIMEOUT_SECS = 300.0
