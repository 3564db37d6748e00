"""Weights carried across from the JAX package's flax param tree.

``state_dict_from_flax`` maps the transformer LM's param tree (nested
dicts of numpy arrays, as ``flax.serialization.msgpack_restore`` or
``jax.tree.map(np.asarray, params)`` give it) onto
``models.transformer.TransformerLM``'s ``state_dict``:

- Dense kernels (in, out) → ``Linear.weight`` (out, in);
- DenseGeneral q/k/v kernels (d, H, Dh) → (H·Dh, d), biases (H, Dh) →
  (H·Dh,); the out kernel (H, Dh, d) → (d, H·Dh);
- LayerNorm ``scale`` → ``weight``;
- ``token_embed/embedding`` → ``token_embed.weight``; ``pos_embed`` as is;
- an MoE block's ``moe/router`` as a Dense, its experts ``moe/wi``
  (E, d, F) and ``moe/wo`` (E, F, d) as they are (the port keeps
  flax's layout for them).

``pipeline_state_dict_from_flax`` carries a JAX ``PipelineLM`` tree
(``{"ends", "blocks"}``, the blocks' leaves stacked ``(pp, L, ...)``)
into the port's ``PipelineLM``, each layer mapped as above and stacked
again.

``config_from_params`` reads the architecture off the shapes (which
blocks hold ``moe`` gives ``moe_every``) and ``init_flax_params`` makes
a seeded numpy tree in the same layout (the flax initializers' scales,
for random-weight runs). The MoE routing options are not in the
parameters: a caller names them, or ``config_from_params`` raises.

``sparse_state_from_flax`` carries a JAX ``SparseTrainState``'s dense
params (the recsys ranker's ``Dense_k``) and its tables, slot tables and
apply counts across, and ``load_sparse_state`` copies them into the
port's ``SparseTrainState`` in place: the JAX tables come from
``jax.random`` and cannot be redrawn in torch.

``deepfm_state_dict_from_flax`` maps the DeepFM zoo models' flax params
onto the twins' ``state_dict``: ``Dense_k`` → ``deep.layers.k`` (kernel
transposed), the embedding tables (``fm_embedding``, ``fm_linear``) →
``<name>.embedding`` (the port's ``Embedding``) or ``<name>.weight``
(``nn.Embedding``). ``copy_host_table`` carries a host table's rows,
``(ids, rows)`` through ``to_arrays``/``set``, from a JAX
``EmbeddingTable`` or ``NativeEmbeddingTable`` into the port's.

``is_jax_named`` and ``port_leaves_from_jax`` read a checkpoint the
JAX package wrote (the same shard files, but each leaf named by
``jax.tree_util.keystr``: ``params['Conv_0']['kernel']``,
``opt_state[0].trace['Conv_0']['kernel']``) into the port's leaf names
for a given train state (``checkpoint/state_io.py``): the params and
the optimizer's slots go through the twin's weight map below (kernels
transposed), optax's ``mu``/``nu``/``trace`` become torch's
``exp_avg``/``exp_avg_sq``/``momentum_buffer`` and its one ``count``
each parameter's ``step``; the device-tier tables keep their names.

``flax_state_dict`` carries a flax model's ``params`` (and
``batch_stats``) into a zoo twin's ``state_dict`` by module path: the
vision and tabular twins name their submodules as flax does
(``Conv_0``, ``BatchNorm_0``, ``Dense_0``, and the named ones:
``norm1``, ``stage{s}_block{b}``, ``head``, ``wide_weights``,
``deep_embedding``, ``features/education_embedding``, ...), so
``A/B/leaf`` becomes ``A.B.leaf``. Conv kernels (kh, kw, in, out)
become ``weight`` (out, in, kh, kw), Dense kernels (in, out) ``weight``
(out, in); every other leaf keeps its name (BatchNorm's ``scale``,
``bias``, ``mean`` and ``var``, a table's ``embedding``, a top-level
parameter such as ``wide_weights``).
"""

import re
from typing import Dict, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common import dtypes
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.models.transformer import TransformerConfig

logger = get_logger(__name__)


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


MOE_OPTIONS = ("moe_top_k", "moe_dispatch", "moe_capacity_factor")


def config_from_params(params: dict, compute_dtype=torch.bfloat16,
                       **moe) -> TransformerConfig:
    """The TransformerConfig whose module has these parameter shapes.
    MoE parameters fix ``moe_experts`` and ``moe_every`` (the first MoE
    block is block ``moe_every - 1``, and every ``moe_every``-th after
    it); ``moe_top_k``, ``moe_dispatch`` and ``moe_capacity_factor`` are
    not in them, so for MoE parameters each must be passed in ``moe``
    (ValueError names the missing ones; nothing is guessed)."""
    params = _params(params)
    vocab, d_model = np.shape(params["token_embed"]["embedding"])
    block = params["block_0"]
    _, n_heads, head_dim = np.shape(block["attn"]["query"]["kernel"])
    n_layers = _n_layers(params)
    moe_blocks = [i for i in range(n_layers)
                  if "moe" in params[f"block_{i}"]]
    moe_params = [params[f"block_{i}"]["moe"] for i in moe_blocks]
    d_ff = (np.shape(block["mlp"]["wi"]["kernel"])[1] if "mlp" in block
            else np.shape(moe_params[0]["wi"])[2])
    extra = {}
    if moe_blocks:
        every = moe_blocks[0] + 1
        if moe_blocks != [i for i in range(n_layers) if (i + 1) % every == 0]:
            raise ValueError(
                f"MoE in blocks {moe_blocks}: not every k-th block")
        missing = [name for name in MOE_OPTIONS if name not in moe]
        if missing:
            raise ValueError(
                f"MoE parameters do not record {', '.join(missing)}: pass "
                "them (e.g. from the zoo module that trained the model)")
        extra = dict(moe_experts=int(np.shape(moe_params[0]["wi"])[0]),
                     moe_every=every, **{n: moe[n] for n in MOE_OPTIONS})
    return TransformerConfig(
        vocab_size=int(vocab), d_model=int(d_model), n_heads=int(n_heads),
        n_layers=n_layers, d_ff=int(d_ff),
        max_len=int(np.shape(params["pos_embed"])[0]),
        compute_dtype=compute_dtype, **extra,
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

    for i in range(_n_layers(params)):
        for name, value in _block_state(params[f"block_{i}"]).items():
            out[f"blocks.{i}.{name}"] = value
    out.update(_prefixed("ln_f", _layer_norm(params["ln_f"])))
    out.update(_prefixed("lm_head", _dense(params["lm_head"])))
    return out


def _prefixed(prefix: str, tensors: dict) -> dict:
    return {f"{prefix}.{name}": value for name, value in tensors.items()}


def _block_state(block: dict) -> Dict[str, torch.Tensor]:
    """One flax ``Block``'s params as the port's ``Block.state_dict()``."""
    out = {}
    out.update(_prefixed("ln1", _layer_norm(block["ln1"])))
    out.update(_prefixed("ln2", _layer_norm(block["ln2"])))
    for name in ("query", "key", "value"):
        out.update(_prefixed(f"attn.{name}", _dense(block["attn"][name])))
    out.update(_prefixed("attn.out", _out_dense(block["attn"]["out"])))
    if "moe" in block:
        moe = block["moe"]
        out.update(_prefixed("moe.router", _dense(moe["router"])))
        out.update({"moe.wi": _t(moe["wi"]), "moe.wo": _t(moe["wo"])})
    else:
        out.update(_prefixed("mlp.wi", _dense(block["mlp"]["wi"])))
        out.update(_prefixed("mlp.wo", _dense(block["mlp"]["wo"])))
    return out


def _index_tree(tree, index):
    if isinstance(tree, dict):
        return {k: _index_tree(v, index) for k, v in tree.items()}
    return np.asarray(tree)[index]


def pipeline_state_dict_from_flax(params: dict, pp: int,
                                  layers_per_stage: Optional[int] = None
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX ``PipelineLM`` params tree (``{"ends": {token_embed,
    pos_embed, ln_f, lm_head}, "blocks": <Block tree, leaves (pp, L,
    ...)>}``) as the port's ``PipelineLM.state_dict()`` (whole: every
    stage). ``pp``: the stage count the port's model has; ValueError
    where the tree's stage stack is not ``pp`` (or ``layers_per_stage``)
    long, instead of carrying a wrong depth."""
    ends, blocks = params["ends"], params["blocks"]
    lead = {np.shape(leaf)[:2] for leaf in _leaves(blocks)}
    want = (pp, layers_per_stage) if layers_per_stage else None
    if len(lead) != 1 or next(iter(lead))[0] != pp or (
            want and next(iter(lead)) != want):
        raise ValueError(
            f"PipelineLM blocks stacked as {sorted(lead)}, not "
            f"({pp}, {layers_per_stage or 'L'}, ...): the stage count "
            "differs")
    _, depth = next(iter(lead))
    layers = [[_block_state(_index_tree(blocks, (s, layer)))
               for layer in range(depth)] for s in range(pp)]
    out = {"ends.token_embed.weight": _t(ends["token_embed"]["embedding"]),
           "ends.pos_embed": _t(ends["pos_embed"])}
    out.update(_prefixed("ends.ln_f", _layer_norm(ends["ln_f"])))
    out.update(_prefixed("ends.lm_head", _dense(ends["lm_head"])))
    for name in layers[0][0]:
        out[f"blocks.{name}"] = torch.stack([
            torch.stack([layers[s][layer][name] for layer in range(depth)])
            for s in range(pp)])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


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
    e = cfg.moe_experts
    for i in range(cfg.n_layers):
        block = params[f"block_{i}"] = {
            "ln1": ln(), "ln2": ln(),
            "attn": {
                **{name: dense((d, h, dh), d, (h, dh))
                   for name in ("query", "key", "value")},
                "out": dense((h, dh, d), h * dh, (d,)),
            },
        }
        if e > 0 and (i + 1) % cfg.moe_every == 0:
            # flax's lecun_normal fans over (E, in, out): fan_in in·E.
            block["moe"] = {"router": dense((d, e), d, (e,)),
                            "wi": normal((e, d, f), d * e),
                            "wo": normal((e, f, d), f * e)}
        else:
            block["mlp"] = {"wi": dense((d, f), d, (f,)),
                            "wo": dense((f, d), f, (d,))}
    return params


def sparse_state_from_flax(params: dict, tables: dict, slot_tables: dict,
                           table_steps: dict) -> dict:
    """A JAX sparse train state's leaves (numpy) for the port:
    ``{"model": state_dict, "tables": {name: (V, D)}, "slot_tables":
    {name: {slot: (V, D)}}, "table_steps": {name: int}}``. Dense kernels
    ``Dense_k`` (in, out) become ``layers.k.weight`` (out, in)."""
    return {
        "model": _dense_layers(_params(params), "layers"),
        "tables": {name: _t(t) for name, t in tables.items()},
        "slot_tables": {name: {slot: _t(v) for slot, v in slots.items()}
                        for name, slots in slot_tables.items()},
        "table_steps": {name: int(np.asarray(v))
                        for name, v in table_steps.items()},
    }


def _dense_layers(params: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """flax ``Dense_k`` (in, out) → ``{prefix}.k.weight`` (out, in) and
    ``{prefix}.k.bias``."""
    out = {}
    k = 0
    while f"Dense_{k}" in params:
        for name, value in _dense(params[f"Dense_{k}"]).items():
            out[f"{prefix}.{k}.{name}"] = value
        k += 1
    return out


def deepfm_state_dict_from_flax(params: dict,
                                embed_param: str = "embedding"
                                ) -> Dict[str, torch.Tensor]:
    """A DeepFM twin's ``state_dict`` for the JAX model's params: the
    deep tower's ``Dense_k`` and every top-level table (a module holding
    ``embedding``) as ``<name>.<embed_param>`` ("embedding" for the
    port's ``Embedding`` layer, "weight" for ``nn.Embedding``). A host
    model has no table among its params: its rows cross with
    ``copy_host_table``."""
    params = _params(params)
    out = _dense_layers(params, "deep.layers")
    for name, node in params.items():
        if isinstance(node, dict) and "embedding" in node:
            out[f"{name}.{embed_param}"] = _t(node["embedding"])
    return out


def copy_host_table(src, dst):
    """Set every row of host table ``src`` into ``dst`` (any pair of the
    two packages' ``EmbeddingTable``/``NativeEmbeddingTable``); returns
    ``dst``."""
    ids, rows = src.to_arrays()
    if len(ids):
        dst.set(np.asarray(ids, np.int64), np.asarray(rows, np.float32))
    return dst


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


def flax_state_dict(params: dict, batch_stats: Optional[dict] = None
                    ) -> Dict[str, torch.Tensor]:
    """A zoo twin's ``state_dict`` for a flax model's ``params`` (or
    its whole variables dict, ``{"params", "batch_stats"}``) and
    ``batch_stats``, nested dicts of numpy arrays, each tensor in its
    array's dtype. A gradient tree (the params' shape) maps the same
    way."""
    if "params" in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    out = {}

    def walk(node, prefix):
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}.")
                continue
            value = np.asarray(value)
            if name == "kernel":
                value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                         else value.T)
                name = "weight"
            out[f"{prefix}{name}"] = torch.from_numpy(
                np.array(value, copy=True))

    walk(params, "")
    walk(batch_stats or {}, "")
    return out


def state_dict_for(model: torch.nn.Module, variables: dict
                   ) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` for a flax bundle's variables
    (``{"params", "batch_stats", ...}``), by the map of the twin that
    ``model`` is: the transformer LM's, the DeepFM twins' (a ``deep``
    tower; the tables' leaf is ``weight`` where the twin holds an
    ``nn.Embedding``), else ``flax_state_dict`` by module path (the
    vision and tabular twins)."""
    from elasticdl_tpu_torch.model_zoo.deepfm.fm_layers import DeepTower
    from elasticdl_tpu_torch.models.transformer import TransformerLM

    if isinstance(model, TransformerLM):
        return state_dict_from_flax(variables)
    if isinstance(getattr(model, "deep", None), DeepTower):
        embed_param = ("weight" if any(
            isinstance(m, torch.nn.Embedding) for m in model.children())
            else "embedding")
        return deepfm_state_dict_from_flax(variables, embed_param)
    return flax_state_dict(variables)


# ---- checkpoints the JAX package wrote ------------------------------------

# optax's slot fields -> torch's optimizer-state keys (the zoo's Adam and
# SGD-with-momentum); optax's ``count`` becomes every parameter's step.
OPTAX_SLOTS = {"mu": "exp_avg", "nu": "exp_avg_sq",
               "trace": "momentum_buffer"}
_KEY_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def is_jax_named(named: Dict[str, np.ndarray]) -> bool:
    """Leaves named by ``jax.tree_util.keystr`` (``params['Dense_0']
    ['kernel']``); the port's names never hold a bracket."""
    return any("[" in name for name in named)


def _keystr_tokens(path: str):
    """``[0].mu['Dense_0']['kernel']`` -> [(kind, value), ...] with kind
    "key" (a dict key), "index" or "attr"."""
    tokens, pos = [], 0
    while pos < len(path):
        m = _KEY_TOKEN.match(path, pos)
        if m is None:
            raise ValueError(f"cannot parse JAX leaf path {path!r}")
        if m.group(1) is not None:
            tokens.append(("key", m.group(1)))
        elif m.group(2) is not None:
            tokens.append(("index", int(m.group(2))))
        else:
            tokens.append(("attr", m.group(3)))
        pos = m.end()
    return tokens


def _set_path(tree: dict, keys, value):
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def _as_f32(value) -> np.ndarray:
    value = np.asarray(value)
    if value.dtype == dtypes.BFLOAT16_BITS:
        return dtypes.bf16_from_numpy(value).float().numpy()
    return value


def _weight_map(model, variables: dict) -> Dict[str, torch.Tensor]:
    """The twin's ``state_dict`` names for a flax variables tree (a slot
    tree maps as the params it shadows)."""
    from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (
        RecsysRanker,
    )
    from elasticdl_tpu_torch.models.pipeline_lm import PipelineLM

    if isinstance(model, RecsysRanker):
        return _dense_layers(_params(variables), "layers")
    if isinstance(model, PipelineLM):
        return pipeline_state_dict_from_flax(_params(variables),
                                             model.pp_size)
    return state_dict_for(model, variables)


def port_leaves_from_jax(state, named: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """A JAX-named leaf dict (``checkpoint.state_io`` of the JAX package)
    as the port's names for ``state``. Kernels are transposed as
    ``flax_state_dict`` transposes them; a leaf that maps to nothing of
    the state raises ValueError. JAX's ``rng`` (a PRNG key) has no
    counterpart in a ``torch.Generator``'s state: the port's generator
    keeps its own seeded state, and a log line says so."""
    variables = {"params": {}, "batch_stats": {}}
    slots: Dict[str, dict] = {}           # torch slot -> params-shaped tree
    counts: Dict[tuple, np.ndarray] = {}  # opt_state prefix -> count
    slot_prefix = set()
    out: Dict[str, np.ndarray] = {}
    for name, value in named.items():
        # the state's field, then the keystr path below it
        head = re.match(r"\w+", name).group(0)
        tokens = _keystr_tokens(name[len(head):])
        keys = [v for kind, v in tokens if kind == "key"]
        if head in ("params", "batch_stats"):
            _set_path(variables[head], keys, _as_f32(value))
        elif head == "opt_state":
            attrs = [i for i, (kind, _v) in enumerate(tokens)
                     if kind == "attr"]
            if not attrs:
                raise ValueError(f"JAX leaf {name}: no optax field")
            at = attrs[-1]
            field, prefix = tokens[at][1], tuple(tokens[:at])
            if field == "count":
                counts[prefix] = np.asarray(value)
            elif field in OPTAX_SLOTS:
                slot_prefix.add(prefix)
                _set_path(slots.setdefault(OPTAX_SLOTS[field], {}),
                          [v for kind, v in tokens[at + 1:]
                           if kind == "key"], _as_f32(value))
            else:
                raise ValueError(
                    f"JAX leaf {name}: optax field {field!r} has no "
                    "torch slot this port maps")
        elif head == "tables":
            out[f"tables.{keys[0]}"] = np.asarray(value)
        elif head == "slot_tables":
            out[f"slot_tables.{keys[0]}.{keys[1]}"] = np.asarray(value)
        elif head == "table_steps":
            out[f"table_steps.{keys[0]}"] = np.asarray(value, np.int64)
        elif head == "step":
            out["step"] = np.asarray(value, np.int64)
        elif head == "rng":
            logger.info(
                "JAX checkpoint's rng (a PRNG key) has no torch.Generator "
                "counterpart; the port's generator keeps its own seed")
        else:
            raise ValueError(f"JAX leaf {name}: no port counterpart")

    model = state.model
    param_names = {n for n, _ in model.named_parameters()}
    stats = set(getattr(state, "batch_stats", {}) or {})
    for key, tensor in _weight_map(model, variables).items():
        if key in param_names:
            out[f"params.{key}"] = tensor.numpy()
        elif key in stats:
            out[f"batch_stats.{key}"] = tensor.numpy()
        else:
            raise ValueError(
                f"JAX leaf maps to {key}, which {type(model).__name__} "
                "holds as neither a parameter nor a statistic")
    if getattr(state, "generator", None) is not None:
        out["rng"] = state.generator.get_state().numpy()
    step_count = None
    if slots:
        # the count that sits beside the slots (a schedule's own count,
        # ``opt_state[1].count`` under a LearningRateScheduler, is not it)
        beside = [counts[p] for p in slot_prefix if p in counts]
        if beside:
            step_count = np.asarray(beside[0], np.float32)
    for slot, tree in slots.items():
        for key, tensor in _weight_map(model, {"params": tree}).items():
            out[f"opt_state.{key}.{slot}"] = tensor.numpy()
            if step_count is not None:
                out[f"opt_state.{key}.step"] = step_count
    return out
