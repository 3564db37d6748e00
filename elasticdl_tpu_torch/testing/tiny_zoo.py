"""Shrink zoo models to test shapes, reversibly (port of
elasticdl_tpu/testing/tiny_zoo.py).

The recsys twin's table is 1M x 256 (1 GB f32); CPU tests need the same
model at a toy vocabulary. The override has three coupled parts (module
globals read at ``custom_model()`` call time, the TABLE_SPECS tuple,
and a ``model_spec.load_module`` route so ``get_model_spec``'s by-path
import resolves to the patched module instance); one context manager
keeps them together and guarantees restoration — a job that leaves the
zoo shrunk would silently poison any later in-process job.
"""

from contextlib import contextmanager


@contextmanager
def tiny_recsys_zoo(vocab: int = 64, dim: int = 16):
    """Patch the recsys twin to ``vocab`` x ``dim`` and route
    ``model_spec.load_module`` at it; yields the patched module and
    restores everything on exit."""
    import elasticdl_tpu_torch.core.model_spec as ms
    from elasticdl_tpu_torch.embedding.device_sparse import TableSpec
    from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as zoo

    saved = (zoo.VOCAB, zoo.DIM, zoo.TABLE_SPECS, ms.load_module)
    real_load = ms.load_module
    zoo.VOCAB, zoo.DIM = int(vocab), int(dim)
    zoo.TABLE_SPECS = (TableSpec(
        name=zoo.TABLE_NAME, vocab=zoo.VOCAB, dim=zoo.DIM,
        combiner="sum", feature_key=zoo.FEATURE_KEY,
    ),)
    ms.load_module = lambda path: (
        zoo if path.endswith("recsys_sparse.py") else real_load(path)
    )
    try:
        yield zoo
    finally:
        zoo.VOCAB, zoo.DIM, zoo.TABLE_SPECS, ms.load_module = saved
