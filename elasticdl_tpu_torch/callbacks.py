"""User-facing callbacks (port of elasticdl_tpu/callbacks.py).

- ``SavedModelExporter`` exports a serving bundle of the trained module
  when training ends (the port's ``serving/export.export_serving_bundle``:
  its ``state_dict``, BatchNorm statistics included). A host-tier model
  also gets its tables materialised dense up to the zoo module's
  ``host_serving_vocab``; with no vocab, or a vocab that does not fit
  the model, the bundle degrades to params only, with a warning.
- ``Callback.on_train_batch_begin``/``on_train_batch_end`` run around
  every train step (after the state exists), so a caller can time or
  record steps without reaching into the executor.
- ``MaxStepsStopping`` is declarative: executors read ``max_steps`` and
  stop at that model version.
- ``LearningRateScheduler``: ``schedule(version) -> multiplier`` of the
  learning rate. The JAX package chains ``optax.scale_by_schedule``
  after the user optimizer; here a ``LambdaLR`` over the optimizer is
  stepped after every optimizer step (a step post-hook), so step t
  takes schedule(t) as there. Several schedulers multiply. A restore
  stands it at the restored version (``seek_lr_schedule``).
"""

from typing import Callable, List, Optional

import torch

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("callbacks")


class Callback:
    """Minimal callback protocol. Subclasses override what they need."""

    params: dict = {}

    def set_params(self, params: dict):
        self.params = dict(params)

    def on_train_batch_begin(self, owner=None):  # owner: LocalExecutor
        pass

    def on_train_batch_end(self, owner=None, metrics=None):
        """``metrics``: the step's, ``{"loss": device tensor}``."""

    def on_train_end(self, owner=None):
        pass


class SavedModelExporter(Callback):
    """Export a serving bundle when training ends."""

    def __init__(self, output_dir: str, batch_example=None):
        self._output_dir = output_dir
        self._batch_example = batch_example

    def on_train_end(self, owner=None):
        from elasticdl_tpu_torch.serving.export import export_serving_bundle

        state = getattr(owner, "state", None)
        if state is None:
            logger.warning("SavedModelExporter: no trained state to export")
            return
        spec = getattr(owner, "_spec", None)
        batch_example = (self._batch_example
                         if self._batch_example is not None
                         else getattr(owner, "last_batch", None))
        # The whole ``--model_def`` (``pkg.module.fn``) where the owner
        # has one, so ``serve --model_zoo`` can rebuild the module.
        model_def = (getattr(getattr(owner, "_args", None), "model_def", "")
                     or getattr(spec, "model_fn_name", ""))
        # Host-tier models: the tables materialised dense into the
        # bundle, up to the zoo module's host_serving_vocab.
        host_tables = host_vocab = host_lock = None
        runner = getattr(owner, "_step_runner", None)
        engine = getattr(runner, "engine", None)
        if engine is not None and spec is not None:
            host_vocab = getattr(spec.module, "host_serving_vocab", None)
            if host_vocab:
                host_tables = engine.tables
                host_lock = engine.lock
            else:
                # No vocab, no dense tables: the host model cannot
                # serve them, so the bundle degrades to params only.
                logger.warning(
                    "SavedModelExporter: host-tier model without "
                    "host_serving_vocab — exporting params-only bundle"
                )
                batch_example = None
        try:
            export_serving_bundle(
                self._output_dir, state.model, batch_example=batch_example,
                model_def=model_def, version=state.step,
                host_tables=host_tables, host_vocab=host_vocab,
                host_lock=host_lock,
            )
        except ValueError as exc:
            if host_tables is None:
                raise
            # A misconfigured host_serving_vocab must not lose the whole
            # export at the end of a run.
            logger.warning(
                "SavedModelExporter: %s — falling back to a params-only "
                "bundle", exc,
            )
            export_serving_bundle(
                self._output_dir, state.model, batch_example=None,
                model_def=model_def, version=state.step,
            )
        logger.info("Exported serving bundle to %s", self._output_dir)


class MaxStepsStopping(Callback):
    """Stop training at ``max_steps`` model versions."""

    def __init__(self, max_steps: int):
        if max_steps <= 0:
            raise ValueError("max_steps must be positive")
        self.max_steps = int(max_steps)


class LearningRateScheduler(Callback):
    """Version-indexed LR multiplier: ``schedule(version) -> float``."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule


def _scheduled(make_optimizer: Callable, schedules: List[Callable]):
    def build(params):
        optimizer = make_optimizer(params)

        def multiplier(version):
            out = 1.0
            for schedule in schedules:
                out *= float(schedule(version))
            return out

        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, multiplier)
        optimizer.register_step_post_hook(
            lambda opt, args, kwargs: scheduler.step())
        optimizer._lr_scheduler = scheduler
        return optimizer

    return build


def seek_lr_schedule(optimizer, version: int):
    """Stand the LearningRateScheduler folded into ``optimizer`` (if any)
    at ``version``: the rate and position it has after ``version``
    optimizer steps from 0, computed as ``LambdaLR`` computes them. A
    checkpoint restore calls this, since the schedule's position is not
    in the optimizer's state (the JAX package restores the optax
    schedule's count with ``opt_state``). A ZeRO optimizer
    (``parallel/zero.py``) holds the schedule on its ``inner`` one."""
    optimizer = getattr(optimizer, "inner", optimizer)
    scheduler = getattr(optimizer, "_lr_scheduler", None)
    if scheduler is None:
        return
    version = int(version)
    scheduler.last_epoch = version
    for group, base, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(version)
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]


def find_callback(callbacks: Optional[List[Callback]], cls):
    for cb in callbacks or []:
        if isinstance(cb, cls):
            return cb
    return None


def apply_callbacks_to_optimizer(
    make_optimizer: Callable, callbacks: Optional[List[Callback]]
) -> Callable:
    """Fold every LearningRateScheduler into the optimizer factory."""
    schedules = [cb.schedule for cb in callbacks or []
                 if isinstance(cb, LearningRateScheduler)]
    if not schedules:
        return make_optimizer
    return _scheduled(make_optimizer, schedules)


def set_callback_parameters(
    callbacks: Optional[List[Callback]],
    batch_size: int = 0,
    epochs: int = 0,
    verbose: int = 0,
    mode: str = "training",
):
    """Inject job params into each callback."""
    params = {
        "batch_size": batch_size,
        "epochs": epochs,
        "verbose": verbose,
        "mode": mode,
    }
    for cb in callbacks or []:
        cb.set_params(params)
    return callbacks


def ensure_saved_model_exporter(
    callbacks: Optional[List[Callback]], output_dir: str
) -> List[Callback]:
    """``--output`` wiring: point an existing SavedModelExporter at the
    dir, or append one. No-op without an output dir."""
    callbacks = list(callbacks or [])
    if not output_dir:
        return callbacks
    for cb in callbacks:
        if isinstance(cb, SavedModelExporter):
            cb._output_dir = cb._output_dir or output_dir
            return callbacks
    callbacks.append(SavedModelExporter(output_dir))
    return callbacks
