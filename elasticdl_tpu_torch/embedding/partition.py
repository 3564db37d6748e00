"""Auto-partition threshold (port of the constant of
elasticdl_tpu/embedding/partition.py).

Tables over the threshold are the ones a mesh runner row-shards; the
single-device runner reads it only to keep the JAX runner's signature.
The partition pass itself waits for the parallel slice.
"""

# The reference's 2 MB rule (model_handler.py:85-89).
DEFAULT_PARTITION_THRESHOLD_BYTES = 2 * 1024 * 1024
