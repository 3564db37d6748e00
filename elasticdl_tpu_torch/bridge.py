"""Weights carried across from the JAX package's flax param tree.

``state_dict_from_flax`` maps the transformer LM's param tree (nested
dicts of numpy arrays, as ``flax.serialization.msgpack_restore`` or
``jax.tree.map(np.asarray, params)`` give it) onto
``models.transformer.TransformerLM``'s ``state_dict``:

- Dense kernels (in, out) → ``Linear.weight`` (out, in);
- DenseGeneral q/k/v kernels (d, H, Dh) → (H·Dh, d), biases (H, Dh) →
  (H·Dh,); the out kernel (H, Dh, d) → (d, H·Dh);
- LayerNorm ``scale`` → ``weight``;
- ``token_embed/embedding`` → ``token_embed.weight``; ``pos_embed`` as is.

``config_from_params`` reads the architecture off the shapes and
``init_flax_params`` makes a seeded numpy tree in the same layout (the
flax initializers' scales, for random-weight runs).

``sparse_state_from_flax`` carries a JAX ``SparseTrainState``'s dense
params (the recsys ranker's ``Dense_k``) and its tables, slot tables and
apply counts across, and ``load_sparse_state`` copies them into the
port's ``SparseTrainState`` in place: the JAX tables come from
``jax.random`` and cannot be redrawn in torch.
"""

from typing import Dict

import numpy as np
import torch

from elasticdl_tpu_torch.models.transformer import TransformerConfig


def _params(tree: dict) -> dict:
    """Accept either the params tree or the ``{"params": ...}``
    variables dict around it."""
    if "params" in tree and "token_embed" not in tree:
        return tree["params"]
    return tree


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _n_layers(params: dict) -> int:
    n = 0
    while f"block_{n}" in params:
        n += 1
    return n


def config_from_params(params: dict,
                       compute_dtype=torch.bfloat16) -> TransformerConfig:
    """The TransformerConfig whose module has these parameter shapes."""
    params = _params(params)
    vocab, d_model = np.shape(params["token_embed"]["embedding"])
    block = params["block_0"]
    _, n_heads, head_dim = np.shape(block["attn"]["query"]["kernel"])
    moe = [params[f"block_{i}"]["moe"] for i in range(_n_layers(params))
           if "moe" in params[f"block_{i}"]]
    d_ff = (np.shape(block["mlp"]["wi"]["kernel"])[1] if "mlp" in block
            else np.shape(moe[0]["wi"])[2])
    return TransformerConfig(
        vocab_size=int(vocab), d_model=int(d_model), n_heads=int(n_heads),
        n_layers=_n_layers(params), d_ff=int(d_ff),
        max_len=int(np.shape(params["pos_embed"])[0]),
        moe_experts=int(np.shape(moe[0]["wi"])[0]) if moe else 0,
        compute_dtype=compute_dtype,
    )


def _dense(node) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(node["kernel"])
    return {"weight": _t(kernel.reshape(kernel.shape[0], -1).T),
            "bias": _t(np.asarray(node["bias"]).reshape(-1))}


def _out_dense(node) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(node["kernel"])          # (H, Dh, d)
    return {"weight": _t(kernel.reshape(-1, kernel.shape[-1]).T),
            "bias": _t(node["bias"])}


def _layer_norm(node) -> Dict[str, torch.Tensor]:
    return {"weight": _t(node["scale"]), "bias": _t(node["bias"])}


def state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM.state_dict()`` for a flax param tree."""
    params = _params(params)
    out = {
        "token_embed.weight": _t(params["token_embed"]["embedding"]),
        "pos_embed": _t(params["pos_embed"]),
    }

    def put(prefix, tensors):
        for name, value in tensors.items():
            out[f"{prefix}.{name}"] = value

    for i in range(_n_layers(params)):
        block = params[f"block_{i}"]
        if "mlp" not in block:
            raise NotImplementedError("MoE blocks not yet ported")
        pre = f"blocks.{i}"
        put(f"{pre}.ln1", _layer_norm(block["ln1"]))
        put(f"{pre}.ln2", _layer_norm(block["ln2"]))
        for name in ("query", "key", "value"):
            put(f"{pre}.attn.{name}", _dense(block["attn"][name]))
        put(f"{pre}.attn.out", _out_dense(block["attn"]["out"]))
        put(f"{pre}.mlp.wi", _dense(block["mlp"]["wi"]))
        put(f"{pre}.mlp.wo", _dense(block["mlp"]["wo"]))
    put("ln_f", _layer_norm(params["ln_f"]))
    put("lm_head", _dense(params["lm_head"]))
    return out


def init_flax_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Seeded random weights as a flax-layout tree of f32 numpy arrays:
    lecun-normal scales for kernels (std 1/sqrt(fan_in)), N(0, 1/d)
    token embeddings, N(0, 0.02²) positions, zero biases, unit LN
    scales."""
    rng = np.random.default_rng(seed)
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff

    def normal(shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(np.sqrt(fan_in)))

    def dense(shape, fan_in, bias_shape):
        return {"kernel": normal(shape, fan_in),
                "bias": np.zeros(bias_shape, np.float32)}

    def ln():
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}

    params = {
        "token_embed": {"embedding": normal((cfg.vocab_size, d), d)},
        "pos_embed": (0.02 * rng.standard_normal(
            (cfg.max_len, d), dtype=np.float32)),
        "ln_f": ln(),
        "lm_head": dense((d, cfg.vocab_size), d, (cfg.vocab_size,)),
    }
    for i in range(cfg.n_layers):
        params[f"block_{i}"] = {
            "ln1": ln(), "ln2": ln(),
            "attn": {
                **{name: dense((d, h, dh), d, (h, dh))
                   for name in ("query", "key", "value")},
                "out": dense((h, dh, d), h * dh, (d,)),
            },
            "mlp": {"wi": dense((d, f), d, (f,)),
                    "wo": dense((f, d), f, (d,))},
        }
    return params


def sparse_state_from_flax(params: dict, tables: dict, slot_tables: dict,
                           table_steps: dict) -> dict:
    """A JAX sparse train state's leaves (numpy) for the port:
    ``{"model": state_dict, "tables": {name: (V, D)}, "slot_tables":
    {name: {slot: (V, D)}}, "table_steps": {name: int}}``. Dense kernels
    ``Dense_k`` (in, out) become ``layers.k.weight`` (out, in)."""
    params = _params(params)
    model = {}
    k = 0
    while f"Dense_{k}" in params:
        for name, value in _dense(params[f"Dense_{k}"]).items():
            model[f"layers.{k}.{name}"] = value
        k += 1
    return {
        "model": model,
        "tables": {name: _t(t) for name, t in tables.items()},
        "slot_tables": {name: {slot: _t(v) for slot, v in slots.items()}
                        for name, slots in slot_tables.items()},
        "table_steps": {name: int(np.asarray(v))
                        for name, v in table_steps.items()},
    }


def load_sparse_state(state, carried: dict):
    """Copy ``sparse_state_from_flax``'s output into a port
    ``SparseTrainState`` in place (the optimizer keeps its parameters)."""
    state.model.load_state_dict(carried["model"])
    with torch.no_grad():
        for name, table in carried["tables"].items():
            state.tables[name].copy_(table)
        for name, slots in carried["slot_tables"].items():
            for slot, value in slots.items():
                state.slot_tables[name][slot].copy_(value)
    state.table_steps.update(carried["table_steps"])
    return state
