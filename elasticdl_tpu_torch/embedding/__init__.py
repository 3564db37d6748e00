"""The device-tier sparse embedding plane of the port: ragged ids and
combiners, the row optimizers, the ``Embedding`` layer and the
single-device ``DeviceSparseRunner``. The host tier waits for its
slice."""

from elasticdl_tpu_torch.embedding.combiner import (  # noqa: F401
    COMBINERS,
    RaggedIds,
    combine,
)
from elasticdl_tpu_torch.embedding.device_sparse import (  # noqa: F401
    DeviceSparseRunner,
    SparseEmbed,
    SparseTrainState,
    TableSpec,
    build_sparse_multi_step,
    build_sparse_train_step,
    init_sparse_state,
    sparse_template,
)
from elasticdl_tpu_torch.embedding.layer import Embedding  # noqa: F401
from elasticdl_tpu_torch.embedding.optimizer import (  # noqa: F401
    SGD,
    Adagrad,
    Adam,
    AdamAmsgrad,
    Momentum,
    RowOptimizer,
    init_slot_tables,
    make_row_optimizer,
    pack_table,
    sparse_apply,
    sparse_apply_packed,
    unique_pad,
    unpack_table,
)
from elasticdl_tpu_torch.embedding.partition import (  # noqa: F401
    DEFAULT_PARTITION_THRESHOLD_BYTES,
)
