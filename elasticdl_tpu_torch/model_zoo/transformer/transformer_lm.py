"""Transformer language model — zoo twin of
model_zoo/transformer/transformer_lm.py: the model, its loss, optimizer,
dataset and eval metrics under the zoo contract's names.

Records are msgpack payloads {"tokens": [seq_len+1 ints]}; features are
tokens[:-1], labels tokens[1:] (next-token prediction).
"""

import numpy as np
import torch

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    generate,
    transformer_sharding_rules,
)
from elasticdl_tpu_torch.ops.losses import (
    fused_next_token_cross_entropy,
    masked_next_token_cross_entropy,
)
from elasticdl_tpu_torch.parallel import rules as rules_lib

CONFIG = TransformerConfig(
    vocab_size=256,
    d_model=128,
    n_heads=8,
    n_layers=2,
    d_ff=256,
    max_len=128,
)


def custom_model(config: TransformerConfig = CONFIG, device=None,
                 mesh=None) -> torch.nn.Module:
    """The model on ``device`` (CUDA unless "cpu" is asked for; with a
    ``mesh`` and no device, the mesh's device). With a mesh, attention
    is the ring over its ``sp`` axis."""
    if device is None and mesh is not None:
        device = mesh.device
    return TransformerLM(config, mesh=mesh).to(resolve_device(device)).eval()


def generate_text(model_or_state, prompt_tokens, max_new_tokens,
                  temperature=0.0, generator=None,
                  config: TransformerConfig = CONFIG):
    """KV-cache decoding with the trained model (greedy by default;
    sampled from ``generator``, a CPU ``torch.Generator``, above 0)."""
    return generate(config, model_or_state, prompt_tokens, max_new_tokens,
                    temperature=temperature, generator=generator)


def param_sharding_rules():
    return transformer_sharding_rules()


def batch_sharding_rule(path, leaf):
    """Token ids/labels (B, S) shard over dp×sp; the row mask (B,) over
    dp."""
    name = rules_lib.path_str(path)
    if name in ("features", "labels") and getattr(leaf, "ndim", 0) == 2:
        return rules_lib.PartitionSpec("dp", "sp")
    return rules_lib.PartitionSpec("dp")


def loss(labels, predictions, mask):
    """Per-token next-token cross entropy; ``mask`` is the (B,) padded-row
    mask from the batcher, broadcast over the token dim. A fused-head
    model (``config.fused_head``) gives (hidden, kernel, bias) in
    training, which takes the chunked loss that holds no logits."""
    if isinstance(predictions, tuple):
        return fused_next_token_cross_entropy(labels, predictions, mask)
    return masked_next_token_cross_entropy(labels, predictions, mask)


def optimizer(lr=1e-3):
    return lambda params: torch.optim.Adam(params, lr=lr)


def dataset_fn(records, mode, metadata):
    seqs = []
    for payload in records:
        rec = tensor_utils.loads(payload)
        seqs.append(np.asarray(rec["tokens"], np.int32))
    tokens = np.stack(seqs)
    return tokens[:, :-1], tokens[:, 1:]


def eval_metrics_fn():
    def token_accuracy(labels, outputs):
        return float(np.mean(np.argmax(outputs, axis=-1) == labels))

    def perplexity(labels, outputs):
        logits = np.asarray(outputs, np.float64)
        logits -= logits.max(axis=-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
        ll = np.take_along_axis(
            logp, np.asarray(labels)[..., None].astype(np.int64), axis=-1
        )[..., 0]
        return float(np.exp(-ll.mean()))

    return {"token_accuracy": token_accuracy, "perplexity": perplexity}
