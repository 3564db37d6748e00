"""Preprocessing package of the port (port of
elasticdl_tpu/preprocessing/), with the JAX package's exports.

- **host transforms** (`transforms`, `feature_group`): numpy,
  string-capable, run inside the user's ``dataset_fn`` on the worker
  host (strings never reach the device); copies of the JAX package's;
- **device layers** (`layers`): tensor ops on the model's device, with
  XLA's integer arithmetic;
- **feature columns** (`feature_column`): both planes behind the TF
  column surface, ``DenseFeatures`` an ``nn.Module``.
"""

from elasticdl_tpu_torch.preprocessing.feature_column import (  # noqa: F401
    DenseFeatures,
    apply_host_transforms,
    bucketized_column,
    categorical_column_with_hash_bucket,
    categorical_column_with_identity,
    categorical_column_with_vocabulary_list,
    concatenated_categorical_column,
    embedding_column,
    indicator_column,
    numeric_column,
)
from elasticdl_tpu_torch.preprocessing.feature_group import (  # noqa: F401
    FeatureGroup,
    concat_feature_ids,
)
from elasticdl_tpu_torch.preprocessing.layers import (  # noqa: F401
    AddIdOffset,
    Discretization,
    Hashing,
    RoundIdentity,
)
from elasticdl_tpu_torch.preprocessing.transforms import (  # noqa: F401
    CategoryHash,
    CategoryLookup,
    NumericBucket,
    to_number,
)
