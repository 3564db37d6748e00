"""Train / evaluate step builders (port of elasticdl_tpu/core/step.py).

Where the JAX package jits one XLA program per step, here each step
runs eagerly on the model's device: forward, backward, optimizer apply.
Batches come from data/batcher.py as numpy trees padded to a static
shape with a ``mask``; the step moves them to the device. Nothing on a
step reads a value back from the card: ``metrics["loss"]`` stays a
device tensor, and callers read it where they need the number.
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
    return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=device),
                    tree)


def _apply_model(state, features, training: bool):
    model = state.model
    model.train(training)
    if training and state.model_takes_generator:
        return model(features, generator=state.generator)
    return model(features)


def _loss_and_grads(call_loss: Callable, state, batch):
    dev = state.device
    features = _to_device(batch["features"], dev)
    labels = _to_device(batch["labels"], dev)
    mask = torch.as_tensor(batch["mask"], device=dev)
    state.optimizer.zero_grad(set_to_none=True)
    preds = _apply_model(state, features, training=True)
    loss = call_loss(labels, preds, mask)
    loss.backward()
    return loss.detach()


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


def build_grad_step(loss_fn: Callable) -> Callable:
    """``(state, batch) -> (grads, metrics)`` without applying: grads
    are {parameter name: tensor}."""

    call_loss = _call_loss(loss_fn)

    def grad_step(state, batch):
        loss = _loss_and_grads(call_loss, state, batch)
        grads = {name: p.grad.detach().clone()
                 for name, p in state.model.named_parameters()
                 if p.grad is not None}
        state.optimizer.zero_grad(set_to_none=True)
        return grads, {"loss": loss}

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
