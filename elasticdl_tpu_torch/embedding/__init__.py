"""The sparse embedding plane of the port: ragged ids and combiners,
the row optimizers, the ``Embedding`` layer, the single-device
``DeviceSparseRunner`` (device tier) and the host tier (lazy host
tables, ``HostEmbeddingEngine``, ``HostStepRunner``), and the row
service that shares the host tier across worker processes
(``HostRowService``, ``make_remote_engine``)."""

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
from elasticdl_tpu_torch.embedding.host_engine import (  # noqa: F401
    MIN_BUCKET,
    HostEmbedding,
    HostEmbeddingEngine,
    HostStepRunner,
    PreparedBatch,
    bucket_size,
    build_host_eval_step,
    build_host_train_step,
    host_rows_template,
    locked_checkpoint_tables,
)
from elasticdl_tpu_torch.embedding.layer import Embedding  # noqa: F401
from elasticdl_tpu_torch.embedding.optimizer import (  # noqa: F401
    SGD,
    Adagrad,
    Adam,
    AdamAmsgrad,
    HostOptimizerWrapper,
    Momentum,
    RowOptimizer,
    init_slot_tables,
    make_row_optimizer,
    pack_table,
    sparse_apply,
    sparse_apply_packed,
    unique_pad,
    unpack_table,
    wrapper_state_tables,
)
from elasticdl_tpu_torch.embedding.partition import (  # noqa: F401
    DEFAULT_PARTITION_THRESHOLD_BYTES,
    embedding_partition_rule,
    partition_specs,
)
from elasticdl_tpu_torch.embedding.row_service import (  # noqa: F401
    HostRowService,
    make_remote_engine,
)
from elasticdl_tpu_torch.embedding.table import (  # noqa: F401
    EmbeddingTable,
    get_slot_table_name,
)
