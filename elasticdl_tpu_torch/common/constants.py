"""Constants the port needs from elasticdl_tpu/common/constants.py
(same names and values)."""


class Mode:
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


class ReaderType:
    CSV = "CSV"
    RECORD_FILE = "RecordFile"
    TEXT = "Text"
    TABLE = "Table"  # row-range table service (not ported yet)
    STREAM = "Stream"  # append-only record stream (not ported yet)
