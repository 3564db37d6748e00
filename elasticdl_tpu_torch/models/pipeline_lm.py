"""Pipeline-parallel transformer LM (port of
elasticdl_tpu/models/pipeline_lm.py).

GPipe pipelining (``parallel/pipeline.py``) in a real model: the token
and position embedding, the final norm and the head (``_EmbedHead``,
"the ends") are replicated, while the block stack is STAGE-STACKED:
each parameter of the flagship's ``Block`` held once for all layers,
with two leading dims ``(pp, layers_per_stage)``, split over the
pipeline axis, each stage running its ``layers_per_stage`` blocks in
turn. dp composes on the microbatch's rows.

The parameters' names follow the JAX tree: ``ends.<name>`` and
``blocks.<the Block's parameter name>`` (``blocks.attn.query.weight`` of
shape ``(pp, L, H·Dh, d)``). A layer runs the flagship's ``Block`` over
its slice of the stacked parameters (in the parameters' place of a
template built on the meta device), so the forward is the flagship's,
kernels included: flash attention's forward (#1) in each block, its backward
(#3, #4) in training.

Placement (``param_shardings``, applied by ``place``): the blocks'
stage dim over ``pp``, the ends whole. Where ``pp`` spans processes a
process holds its block of the stages (as a ``tp`` split holds a
process's block, ``module._placed`` and ``_whole_shapes`` record it),
so a checkpoint writes each stage once. Every process computes the
ends: the embedding's output feeds the first stage, the last stage's
output is broadcast and every process computes the head and the loss.
The gradients of the ends are then the same in every process with no
exchange: the head's from the same loss, the embedding's from the
first stage's input gradient, which the pipeline's backward broadcasts.
"""

from typing import Dict, Optional

import torch
from torch import nn

from elasticdl_tpu_torch.models.transformer import (
    Block,
    Dense,
    LayerNorm,
    TransformerConfig,
)
from elasticdl_tpu_torch.parallel.mesh import NamedSharding
from elasticdl_tpu_torch.parallel.pipeline import (
    microbatch,
    pipeline_apply,
    stack_stage_params,
    unmicrobatch,
)
from elasticdl_tpu_torch.parallel.rules import PartitionSpec as P


class _EmbedHead(nn.Module):
    """The replicated ends of the network: token and position
    embedding, final norm and LM head (flax's ``_EmbedHead``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(
            torch.randn(cfg.max_len, cfg.d_model) * 0.02)
        self.ln_f = LayerNorm(cfg.d_model, cfg.compute_dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.compute_dtype)

    def embed(self, tokens):
        dtype = self.cfg.compute_dtype
        x = self.token_embed(tokens.long()).to(dtype)
        s = tokens.shape[1]
        return x + self.pos_embed[:s].to(dtype)[None]

    def head(self, x):
        return self.lm_head(self.ln_f(x)).float()

    def forward(self, tokens):
        return self.head(self.embed(tokens))


def _stacked_tree(template: nn.Module, lead) -> nn.Module:
    """Plain modules mirroring ``template``'s tree, each parameter
    ``lead + shape`` (uninitialised): no forward reads them directly,
    so their ``_placed`` is the stage placement alone."""
    root = nn.Module()
    for name, param in template.named_parameters():
        *path, leaf = name.split(".")
        module = root
        for part in path:
            if part not in module._modules:
                module.add_module(part, nn.Module())
            module = module._modules[part]
        module.register_parameter(leaf, nn.Parameter(
            torch.empty(tuple(lead) + tuple(param.shape))))
    return root


def _leaf_owner(root: nn.Module, name: str):
    *path, leaf = name.split(".")
    module = root
    for part in path:
        module = module._modules[part]
    return module, leaf


class PipelineLM(nn.Module):
    """The block stack pipelined over ``pp_axis`` of ``mesh``.

    ``n_layers == pp_size * layers_per_stage``; the batch must be
    divisible by ``num_microbatches``. Dropout is refused, as in JAX."""

    def __init__(
        self,
        cfg: TransformerConfig,
        mesh,
        num_microbatches: int = 4,
        layers_per_stage: int = 1,
        pp_axis: str = "pp",
        dp_axis: Optional[str] = "dp",
    ):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.layers_per_stage = layers_per_stage
        self.pp_axis = pp_axis
        self.dp_axis = dp_axis if dp_axis in mesh.axis_names else None
        self.pp_size = mesh.shape[pp_axis]
        if cfg.n_layers != self.pp_size * layers_per_stage:
            raise ValueError(
                f"cfg.n_layers ({cfg.n_layers}) must equal pp_size "
                f"({self.pp_size}) * layers_per_stage "
                f"({layers_per_stage}) — the stage stack IS the depth"
            )
        if cfg.dropout_rate:
            raise NotImplementedError(
                "dropout under pipelining needs per-stage rng "
                "threading; set dropout_rate=0 for PipelineLM"
            )
        others = [a for a in mesh.axis_names if a != pp_axis]
        if mesh.group(others).size > 1:
            # Its train step sums no gradient over processes: only the
            # stages may be split across them.
            raise NotImplementedError(
                f"PipelineLM on {mesh!r}: only {pp_axis!r} may span "
                "processes")
        self.ends = _EmbedHead(cfg)
        # The layer the stages run, without parameters of its own: each
        # call is given its slice of the stacked ones.
        with torch.device("meta"):
            template = Block(cfg)
        self.__dict__["_template"] = template
        # Each parameter's owner and name in the template, by its name.
        self.__dict__["_slots"] = {
            name: _leaf_owner(template, name)
            for name, _ in template.named_parameters()}
        self.blocks = _stacked_tree(
            template, (self.pp_size, layers_per_stage))
        # Drawn on the CPU's default generator (also where the module is
        # built on the meta device, to be loaded afterwards).
        self._init_blocks(torch.Generator().manual_seed(
            int(torch.randint(0, 2 ** 62, (), device="cpu"))))
        self._is_placed = False

    # ---- params --------------------------------------------------------

    def _init_blocks(self, generator: torch.Generator):
        def init_stage(rng):
            layers = []
            for _ in range(self.layers_per_stage):
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(int(torch.randint(
                        0, 2 ** 62, (), generator=rng, device="cpu")))
                    layers.append(dict(Block(self.cfg).named_parameters()))
            return {name: torch.stack([layer[name].detach()
                                       for layer in layers])
                    for name in layers[0]}

        stacked = stack_stage_params(init_stage, generator, self.pp_size)
        with torch.no_grad():
            for name, param in self.blocks.named_parameters():
                param.copy_(stacked[name])

    def init(self, seed: int = 0) -> "PipelineLM":
        """Draw every parameter anew from ``seed``: the ends as the
        module builds them, the blocks stage by stage
        (``stack_stage_params``). Before ``place``."""
        if self._is_placed:
            raise RuntimeError("init after place: the blocks are split")
        device = next(self.parameters()).device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            ends = _EmbedHead(self.cfg)
        self.ends.load_state_dict(ends.state_dict())
        self._init_blocks(torch.Generator().manual_seed(seed))
        return self.to(device)

    def param_shardings(self) -> Dict[str, NamedSharding]:
        """Blocks split their stage dim over pp; the ends replicate."""
        out = {}
        for name, param in self.named_parameters():
            shape = self._whole_shape(name, param)
            spec = (P(self.pp_axis, *([None] * (len(shape) - 1)))
                    if name.startswith("blocks.") else P())
            out[name] = NamedSharding(self.mesh, spec)
        return out

    def _whole_shape(self, name, param):
        if name.startswith("blocks."):
            module, leaf = _leaf_owner(self.blocks, name[len("blocks."):])
            return module.__dict__.get("_whole_shapes", {}).get(
                leaf, tuple(param.shape))
        return tuple(param.shape)

    def place(self) -> "PipelineLM":
        """Apply ``param_shardings``: where pp spans processes, each
        stacked parameter becomes this process's block of the stages
        (before an optimizer holds it). Idempotent."""
        if self._is_placed:
            return self
        for name, sharding in self.param_shardings().items():
            if not name.startswith("blocks."):
                continue
            module, leaf = _leaf_owner(self.blocks, name[len("blocks."):])
            param = getattr(module, leaf)
            module.__dict__.setdefault("_placed", {})[leaf] = sharding
            module.__dict__.setdefault("_whole_shapes", {})[leaf] = tuple(
                param.shape)
            if sharding.spans_processes:
                block = sharding.local_block(param.detach()).clone()
                setattr(module, leaf, nn.Parameter(
                    block, requires_grad=param.requires_grad))
        self._is_placed = True
        return self

    def stacked(self) -> Dict[str, torch.Tensor]:
        """The stage-stacked parameters by their Block name (this
        process's block of the stages where pp spans processes)."""
        return dict(self.blocks.named_parameters())

    # ---- forward -------------------------------------------------------

    def _stage_fn(self, stage_params, act):
        # pipeline_apply took the stage dim off: leaves are
        # (layers_per_stage, ...); run the inner layers, each the
        # template with its slice of every leaf in its parameters' place
        # (what ``torch.func.functional_call`` does, without its
        # per-call bookkeeping, which the host pays 32 times a step).
        names = list(stage_params)
        for layer in zip(*(stage_params[n].unbind(0) for n in names)):
            for name, value in zip(names, layer):
                module, slot = self._slots[name]
                module._parameters[slot] = value
            act = self._template(act)
        return act

    def forward(self, tokens):
        """``tokens`` (B, S) integer ids → f32 logits (B, S, V)."""
        self.place()
        if tokens.dim() != 2:
            raise ValueError(
                f"tokens must be (batch, seq), got {tuple(tokens.shape)}")
        if tokens.shape[1] > self.cfg.max_len:
            raise ValueError(f"sequence length {tokens.shape[1]} > max_len "
                             f"{self.cfg.max_len}")
        x = self.ends.embed(tokens)
        y = pipeline_apply(
            self._stage_fn, self.stacked(),
            microbatch(x, self.num_microbatches), self.mesh,
            axis=self.pp_axis, x_spec=P(None, self.dp_axis, None, None))
        return self.ends.head(unmicrobatch(y))

    def apply(self, tokens, training: bool = False):
        """The forward in training or eval mode (JAX's ``apply``)."""
        self.train(training)
        return self(tokens)

    # ---- training ------------------------------------------------------

    def make_train_step(self, loss_fn, make_optimizer):
        """``step(batch) -> loss``: one update of this model with the
        optimizer ``make_optimizer(parameters)`` (built here, after
        ``place``; ``step.optimizer``). ``batch``: ``features`` (B, S)
        ids, ``labels`` (B, S), ``mask`` (B,), host arrays or tensors.
        The gradients stay in ``.grad`` after the step."""
        self.place()
        optimizer = make_optimizer(self.parameters())
        device = next(self.parameters()).device

        def train_step(batch):
            feats, labels, mask = (torch.as_tensor(batch[k]).to(device)
                                   for k in ("features", "labels", "mask"))
            self.train()
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(labels, self(feats), mask)
            loss.backward()
            optimizer.step()
            return loss.detach()

        train_step.optimizer = optimizer
        return train_step


def sequential_state_dict(state: Dict[str, torch.Tensor], pp: int,
                          layers_per_stage: int
                          ) -> Dict[str, torch.Tensor]:
    """A whole ``PipelineLM`` state (or its gradients by name) as the
    ``state_dict`` of the flagship ``TransformerLM`` with the same
    blocks in order: stage ``s``, layer ``l`` is block
    ``s * layers_per_stage + l``."""
    out = {}
    for name, value in state.items():
        if name.startswith("ends."):
            out[name[len("ends."):]] = value
            continue
        leaf = name[len("blocks."):]
        if tuple(value.shape[:2]) != (pp, layers_per_stage):
            raise ValueError(
                f"{name} of shape {tuple(value.shape)}: not stacked as "
                f"({pp}, {layers_per_stage}, ...)")
        for s in range(pp):
            for layer in range(layers_per_stage):
                out[f"blocks.{s * layers_per_stage + layer}.{leaf}"] = (
                    value[s, layer])
    return out

