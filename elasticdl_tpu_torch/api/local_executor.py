"""LocalExecutor: in-process training without any RPC (port of
elasticdl_tpu/api/local_executor.py).

``--distribution_strategy Local`` runs the whole job in one process:
read shards directly, run the train step on the device (CUDA unless
``--device cpu``), evaluate periodically and at the end, export with
``--output``. ``callbacks`` adds Callback objects to the model spec's
(their batch hooks run around every train step).

A zoo module with ``make_host_runner`` (host-tier models) or
``make_sparse_runner`` (device-tier sparse models) trains through that
runner, a host runner first: its ``init_state`` builds the state at the
first batch, and its ``train_step``/``eval_step`` replace the dense
steps. A host runner's pending row applies are flushed before training
returns, so ``--output`` exports a host model with its tables
materialised dense up to the zoo's ``host_serving_vocab``
(``callbacks.SavedModelExporter``). A device-tier sparse model has no
serving bundle: ``--output`` raises for it, as the JAX export cannot
trace a ``SparseEmbed`` model from its ``params`` alone.

Checkpoints (``checkpoint/``): with ``--checkpoint_dir`` and
``--checkpoint_steps N`` the state is saved every N versions and at the
end (``--checkpoint_shards``, ``--keep_checkpoint_max``,
``--checkpoint_delta_chain``; a host runner's ``host_tables`` ride the
same versions, as deltas where a chain is asked for);
``--checkpoint_dir_for_init`` restores the latest valid version into
the state when it is built, at the first batch (the data is read from
its start: Local has no task fast-forward). ``--tensorboard_log_dir``
writes ``train/loss`` every 100 steps, where the loss is read anyway,
and the final eval metrics.
"""

import time
from typing import Optional

import numpy as np
import torch

from elasticdl_tpu_torch.callbacks import (
    MaxStepsStopping,
    apply_callbacks_to_optimizer,
    ensure_saved_model_exporter,
    find_callback,
    set_callback_parameters,
)
from elasticdl_tpu_torch.checkpoint import CheckpointHook, restore_from_dir
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.common.timing import Timing
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.core.step import (
    build_eval_step,
    build_train_step,
    concat_eval_accumulators,
    evaluate_metrics,
)
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.data.batcher import batch_records, tree_map
from elasticdl_tpu_torch.data.factory import (
    create_data_reader,
    parse_data_reader_params,
)
from elasticdl_tpu_torch.data.prefetch import prefetch


class LocalExecutor:
    def __init__(self, args, callbacks=None):
        self._args = args
        self._logger = get_logger("local_executor", args.log_level)
        self.device = resolve_device(args.device)
        # The model's initial weights come from --random_seed.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.random_seed)
            self._spec = get_model_spec(
                model_zoo=args.model_zoo,
                model_def=args.model_def,
                dataset_fn=args.dataset_fn,
                loss=args.loss,
                optimizer=args.optimizer,
                eval_metrics_fn=args.eval_metrics_fn,
                callbacks=args.callbacks,
                custom_data_reader=args.custom_data_reader,
                device=self.device,
            )
        reader_params = parse_data_reader_params(args.data_reader_params)
        self._train_reader = create_data_reader(
            data_origin=args.training_data,
            custom_reader=self._spec.custom_data_reader,
            **reader_params,
        )
        self._eval_reader = None
        if args.validation_data:
            self._eval_reader = create_data_reader(
                data_origin=args.validation_data,
                custom_reader=self._spec.custom_data_reader,
                **reader_params,
            )
        self._batch_size = args.minibatch_size
        self._epochs = args.num_epochs
        self._max_steps = args.max_steps
        self._evaluation_steps = args.evaluation_steps
        self._timing = Timing(args.log_level.upper() == "DEBUG", self._logger)
        self.state = None
        self.last_batch = None
        self.last_train_metrics = None
        if self._spec.make_host_runner:
            self._step_runner = self._spec.make_host_runner()
        elif self._spec.make_sparse_runner:
            self._step_runner = self._spec.make_sparse_runner()
        else:
            self._step_runner = None
        if self._step_runner is None:
            self._train_step = build_train_step(self._spec.loss)
            self._eval_step = build_eval_step()
        elif args.output and not self._spec.make_host_runner:
            raise NotImplementedError(
                "--output with a sparse runner: the JAX package has no "
                "serving bundle of a device-tier sparse model (its export "
                "passes only params and batch_stats, so a SparseEmbed "
                "model cannot be traced), and the port adds none"
            )
        self._callbacks = ensure_saved_model_exporter(
            (self._spec.callbacks_fn() if self._spec.callbacks_fn else [])
            + list(callbacks or []),
            args.output,
        )
        set_callback_parameters(
            self._callbacks, batch_size=self._batch_size,
            epochs=self._epochs,
        )
        max_steps_cb = find_callback(self._callbacks, MaxStepsStopping)
        if max_steps_cb is not None and not self._max_steps:
            self._max_steps = max_steps_cb.max_steps
        # Checkpointing (reference save inside push_gradients every
        # checkpoint_steps versions, ps/servicer.py:242-257; restore at
        # init from --checkpoint_dir_for_init,
        # ps/parameter_server.py:49-66).
        self._checkpoint = CheckpointHook(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_steps=args.checkpoint_steps,
            num_shards=args.checkpoint_shards,
            # 0 is a legal explicit value meaning "keep everything"
            # (CheckpointSaver.gc).
            keep_max=args.keep_checkpoint_max,
            host_tables=getattr(self._step_runner, "host_tables", None),
            delta_chain_max=args.checkpoint_delta_chain,
        )
        self._init_checkpoint_dir = args.checkpoint_dir_for_init
        self._tb_service = None
        if args.tensorboard_log_dir:
            from elasticdl_tpu_torch.master.tensorboard_service import (
                TensorboardService,
            )

            self._tb_service = TensorboardService(args.tensorboard_log_dir)

    def _task_batches(self, reader, mode):
        gen = self._task_batches_raw(reader, mode)
        # Background decode of batch N+1 while the device runs step N.
        depth = self._args.prefetch_depth
        if depth > 0:
            with prefetch(gen, depth) as batches:
                yield from batches
        else:
            yield from gen

    def _task_batches_raw(self, reader, mode):
        shards = reader.create_shards()
        for task_id, (shard_name, (start, count)) in enumerate(
                shards.items()):
            task = Task(
                task_id=task_id, shard_name=shard_name,
                start=start, end=start + count, type=mode,
            )
            yield from batch_records(
                reader.read_records(task),
                self._batch_size,
                self._spec.dataset_fn,
                mode,
                reader.metadata,
            )

    def _maybe_init_state(self, batch):
        if self.state is None:
            make_optimizer = apply_callbacks_to_optimizer(
                self._spec.make_optimizer(), self._callbacks
            )
            if self._step_runner is None:
                self.state = init_train_state(
                    self._spec.model, make_optimizer,
                    seed=self._args.random_seed,
                )
            else:
                self.state = self._step_runner.init_state(
                    self._spec.model, make_optimizer, batch,
                    seed=self._args.random_seed,
                )
                self._train_step = self._step_runner.train_step(
                    self._spec.loss)
                self._eval_step = self._step_runner.eval_step()
            if self._init_checkpoint_dir:
                self.state = restore_from_dir(
                    self.state, self._init_checkpoint_dir,
                    host_tables=getattr(self._step_runner, "host_tables",
                                        None),
                )
                self._checkpoint.note_version(self.state.step)

    def train(self) -> dict:
        start_time = time.monotonic()
        steps = 0
        examples = 0
        stop = False
        for _ in range(self._epochs):
            if stop:
                break
            for batch in self._task_batches(self._train_reader,
                                            Mode.TRAINING):
                self._maybe_init_state(batch)
                self.last_batch = batch
                for cb in self._callbacks:
                    cb.on_train_batch_begin(self)
                with self._timing.record("batch_process"):
                    self.state, metrics = self._train_step(self.state, batch)
                for cb in self._callbacks:
                    cb.on_train_batch_end(self, metrics)
                self.last_train_metrics = metrics
                steps += 1
                examples += int(np.sum(batch["mask"]))
                with self._timing.record("checkpoint"):
                    self._checkpoint.maybe_save(self.state)
                if steps % 100 == 0:
                    loss = float(metrics["loss"])
                    self._logger.info("step=%d loss=%.5f", steps, loss)
                    if self._tb_service is not None:
                        self._tb_service.write_dict_to_summary(
                            {"train/loss": loss}, steps)
                if self._evaluation_steps and (
                    steps % self._evaluation_steps == 0
                ):
                    self.evaluate()
                if self._max_steps and steps >= self._max_steps:
                    stop = True
                    break
        if self.state is None:
            raise ValueError(
                f"Training data {self._args.training_data!r} produced no "
                "batches; nothing was trained"
            )
        flush = getattr(self._step_runner, "flush", None)
        if flush is not None:
            flush()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._checkpoint.save_final(self.state)
        elapsed = time.monotonic() - start_time
        eval_result = self.evaluate() if self._eval_reader else None
        if eval_result and self._tb_service is not None:
            self._tb_service.write_eval_metrics(steps, eval_result)
        for cb in self._callbacks:
            cb.on_train_end(self)
        if self._tb_service is not None:
            self._tb_service.close()
        self._timing.report_timing()
        return {
            "steps": steps,
            "examples": examples,
            "elapsed_secs": elapsed,
            "examples_per_sec": examples / max(elapsed, 1e-9),
            "final_loss": (
                float(self.last_train_metrics["loss"])
                if self.last_train_metrics is not None else None
            ),
            "eval_metrics": eval_result,
        }

    def evaluate(self) -> Optional[dict]:
        if self._eval_reader is None or self._spec.eval_metrics_fn is None:
            return None
        if self.state is None:
            raise RuntimeError("evaluate() before any training step")
        all_outputs, all_labels = [], []
        for batch in self._task_batches(self._eval_reader, Mode.EVALUATION):
            preds = self._eval_step(self.state, batch)
            real = int(np.sum(batch["mask"]))
            all_outputs.append(preds.float().cpu().numpy()[:real])
            all_labels.append(
                tree_map(lambda x: np.asarray(x)[:real], batch["labels"])
            )
        if not all_outputs:
            self._logger.warning(
                "Validation data produced no batches; skipping evaluation"
            )
            return None
        outputs, labels = concat_eval_accumulators(all_outputs, all_labels)
        metrics = evaluate_metrics(
            self._spec.eval_metrics_fn(), labels, outputs
        )
        self._logger.info("Eval metrics: %s", metrics)
        return metrics

    def run(self):
        return self.train()
