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
)
from elasticdl_tpu_torch.ops.losses import masked_next_token_cross_entropy

CONFIG = TransformerConfig(
    vocab_size=256,
    d_model=128,
    n_heads=8,
    n_layers=2,
    d_ff=256,
    max_len=128,
)


def custom_model(config: TransformerConfig = CONFIG,
                 device=None) -> torch.nn.Module:
    """The model on ``device`` (CUDA unless "cpu" is asked for)."""
    return TransformerLM(config).to(resolve_device(device)).eval()


def loss(labels, predictions, mask):
    """Per-token next-token cross entropy; ``mask`` is the (B,) padded-row
    mask from the batcher, broadcast over the token dim."""
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
