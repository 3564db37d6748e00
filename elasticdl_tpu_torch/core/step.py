"""Train / evaluate step builders (port of elasticdl_tpu/core/step.py).

Where the JAX package jits one XLA program per step, here each step
runs eagerly on the model's device: forward, backward, optimizer apply.
Batches come from data/batcher.py as numpy trees padded to a static
shape with a ``mask``; the step moves them to the device (a batch
already placed there, torch tensors, passes through). Nothing on a step
reads a value back from the card: ``metrics["loss"]`` stays a device
tensor, and callers read it where they need the number.

BatchNorm statistics (the state's ``batch_stats``) move with every
training forward, as the JAX step's mutable ``batch_stats`` do, and
keep their old values where the JAX step keeps them: after a batch with
any padded row (the train, multi-step and accumulating steps), and
after a gradient-only step (``build_grad_step``). The eval step
normalises with the running statistics (``model.eval()``).

Where the state carries a ``global_batch`` (a runner over a mesh that
spans processes gives it one, ``parallel/multihost.attach``) the batch
is this process's rows of the global batch, and the step gives the
global batch's loss and gradients: the mask counts are summed first,
each process weighs its loss by its share of the global count
(``_loss_share``), and the weighted losses and the gradients are
all-reduced in one collective
(``_sum_over_processes``); the statistics keep their old values when
any process's rows hold padding.
"""

import inspect
from typing import Callable, Dict

import numpy as np
import torch

from elasticdl_tpu_torch.data.batcher import tree_map


def _call_loss(loss_fn) -> Callable:
    """``(labels, predictions, mask) -> loss`` around the user loss: the
    padding mask goes only to a loss that accepts 3 args. The signature
    is read once, when a step is built."""
    try:
        nparams = len(inspect.signature(loss_fn).parameters)
    except (TypeError, ValueError):
        nparams = 2
    if nparams >= 3:
        return loss_fn
    return lambda labels, predictions, mask: loss_fn(labels, predictions)


def _to_device(tree, device):
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else torch.as_tensor(np.asarray(x), device=device),
                    tree)


def _stats_keeper(state, mask, update_stats: bool) -> Callable[[], None]:
    """A function to call after the forward that gives the statistic
    buffers back their values from before it where the JAX step keeps
    the old ``batch_stats``: always when ``update_stats`` is False, else
    when a row of the batch is padding (the padding, copies of row 0,
    would move the running averages; the normalisation inside the batch
    still uses it, as in flax). A host mask (numpy: the batch not yet
    placed) is read on the host, and a full batch copies nothing. A mask
    already on the device is not read back: there every buffer takes
    ``torch.where(all rows real, new, old)``. Over a global batch
    (``state.global_batch``) a padded row of any process's keeps them
    (the global batch's rule): the host counts are summed over the CPU
    group, the device flags over the data group."""
    global_batch = state.global_batch
    stats = state.batch_stats
    full = False
    if stats and update_stats:
        if isinstance(mask, torch.Tensor):
            full = (mask.to(state.device) > 0).all()
            if global_batch is not None:
                full = global_batch.sum((~full).to(torch.float32)) == 0
        else:
            padded = float(np.any(np.asarray(mask) <= 0))
            if global_batch is not None:
                padded = global_batch.host_sum(padded)
            if padded == 0:
                stats = {}
    saved = {name: buf.clone() for name, buf in stats.items()}

    def keep():
        with torch.no_grad():
            for name, buf in stats.items():
                buf.copy_(saved[name] if full is False
                          else torch.where(full, buf, saved[name]))

    return keep


def _apply_model(state, features, training: bool):
    model = state.model
    model.train(training)
    if training and state.model_takes_generator:
        return model(features, generator=state.generator)
    return model(features)


def _loss_and_grads(call_loss: Callable, state, batch,
                    update_stats: bool = True):
    dev = state.device
    keep_stats = _stats_keeper(state, batch["mask"], update_stats)
    features = _to_device(batch["features"], dev)
    labels = _to_device(batch["labels"], dev)
    mask = torch.as_tensor(batch["mask"], device=dev)
    state.optimizer.zero_grad(set_to_none=True)
    preds = _apply_model(state, features, training=True)
    loss = call_loss(labels, preds, mask)
    share = _loss_share(state.global_batch, batch["mask"], dev)
    if share is not None:
        loss = loss * share
    loss.backward()
    keep_stats()
    if share is not None:
        return _sum_over_processes(state, loss.detach())
    return loss.detach()


def _loss_share(global_batch, mask, device):
    """Over a global batch, the factor that takes this process's masked
    loss to its share of the global batch's; None without one. A masked
    loss is ``S_p / max(M_p, 1)`` over the local rows (S the masked sum,
    M the mask count), the global one ``sum S_p / max(M, 1)`` with ``M =
    sum M_p``, so the share is ``max(M_p, 1) / max(M, 1)``. It weighs
    the loss before the backward, so every path to the parameters, those
    through another process's BatchNorm statistics among them, carries
    its process's weight. A host mask is counted on the host and summed
    over the CPU group (a float), a placed one over the data group
    (nothing read back from the card). A process whose rows are all
    padding has ``S_p = 0``."""
    if global_batch is None:
        return None
    if isinstance(mask, torch.Tensor):
        count = mask.to(device=device, dtype=torch.float32).sum()
        total = global_batch.sum(count)
        return count.clamp_min(1.0) / total.clamp_min(1.0)
    count = float(np.sum(np.asarray(mask, np.float64)))
    return max(count, 1.0) / max(global_batch.host_sum(count), 1.0)


def _sum_over_processes(state, loss):
    """The global batch's loss and gradients: each process's weighted
    loss (``_loss_share``) and gradients summed over the data group in
    one all-reduce a dtype. Where the runner gave each parameter its own
    group (``GlobalBatch.grad_groups``: a placed parameter's gradient
    is summed over the processes that hold its shard and read other
    data), one all-reduce a group and dtype. Returns the global loss."""
    global_batch = state.global_batch
    total = loss.float().reshape(1).clone()
    groups = getattr(global_batch, "grad_groups", None)
    if groups is None:
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        global_batch.sum_(grads + [total])
        return total[0]
    from elasticdl_tpu_torch.parallel import multihost

    by_group = {global_batch.group.ranks: (global_batch.group, [total])}
    for name, p in state.model.named_parameters():
        if p.grad is not None:
            group = groups[name]
            by_group.setdefault(group.ranks, (group, []))[1].append(p.grad)
    for group, tensors in by_group.values():
        multihost.all_reduce_(tensors, group=group)
    return total[0]


def _train_step_body(call_loss: Callable, state, batch):
    """One forward + backward + apply; shared by the per-batch and
    multi-batch builders."""
    loss = _loss_and_grads(call_loss, state, batch)
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss}


def build_train_step(loss_fn: Callable) -> Callable:
    """``(state, batch) -> (state, metrics)``; the state is updated in
    place and returned."""

    call_loss = _call_loss(loss_fn)

    def train_step(state, batch):
        return _train_step_body(call_loss, state, batch)

    return train_step


def build_multi_step(loss_fn: Callable) -> Callable:
    """``(state, batches) -> (state, metrics)`` where ``batches`` leaves
    carry a leading task dim T (``stack_batches``): T optimizer steps in
    a loop, ``metrics`` leaves stacked to (T,)."""

    call_loss = _call_loss(loss_fn)

    def multi_step(state, batches):
        num_steps = len(batches["mask"])
        losses = []
        for i in range(num_steps):
            batch = tree_map(lambda x: x[i], batches)
            state, metrics = _train_step_body(call_loss, state, batch)
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}

    return multi_step


def stack_batches(batches):
    """[{k: (B,...)}] -> {k: (T, B, ...)} for build_multi_step."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: stack_batches([b[k] for b in batches]) for k in first}
    return np.stack(batches)


def _take_grads(state) -> Dict[str, torch.Tensor]:
    """{parameter name: gradient} of the last backward, the optimizer's
    gradients cleared."""
    grads = {name: p.grad.detach().clone()
             for name, p in state.model.named_parameters()
             if p.grad is not None}
    state.optimizer.zero_grad(set_to_none=True)
    return grads


def build_grad_step(loss_fn: Callable) -> Callable:
    """``(state, batch) -> (grads, metrics)`` without applying: grads
    are {parameter name: tensor}. The statistics keep their values, as
    the JAX grad step's do."""

    call_loss = _call_loss(loss_fn)

    def grad_step(state, batch):
        loss = _loss_and_grads(call_loss, state, batch, update_stats=False)
        return _take_grads(state), {"loss": loss}

    return grad_step


def build_eval_step() -> Callable:
    """``(state, batch) -> predictions`` (a device tensor)."""

    def eval_step(state, batch):
        features = _to_device(batch["features"], state.device)
        with torch.no_grad():
            return _apply_model(state, features, training=False)

    return eval_step


def build_apply_gradients() -> Callable:
    """``(state, grads, lr_scale) -> state``: apply ``grads`` (as
    build_grad_step returns them) scaled by ``lr_scale``."""

    def apply_step(state, grads, lr_scale):
        for name, p in state.model.named_parameters():
            if name in grads:
                p.grad = grads[name] * lr_scale
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state

    return apply_step


def concat_eval_accumulators(outputs_acc, labels_acc):
    """Concatenate per-batch (outputs, labels) accumulators; labels may be
    arrays or dicts of arrays (multi-output models)."""
    outputs = np.concatenate(outputs_acc, axis=0)
    labels = (
        np.concatenate(labels_acc, axis=0)
        if not isinstance(labels_acc[0], dict)
        else {
            k: np.concatenate([d[k] for d in labels_acc], axis=0)
            for k in labels_acc[0]
        }
    )
    return outputs, labels


def evaluate_metrics(
    metrics_fns: Dict[str, Callable], labels, predictions
) -> Dict[str, float]:
    """Apply stateless metric fns to accumulated raw outputs."""
    return {name: float(fn(labels, predictions))
            for name, fn in metrics_fns.items()}
