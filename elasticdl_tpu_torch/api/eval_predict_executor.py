"""Evaluate-only / predict-only jobs booting from a checkpoint (port of
elasticdl_tpu/api/eval_predict_executor.py).

Counterpart of the reference's ``elasticdl evaluate|predict`` flows
(scripts/client_test.sh evaluate/predict blocks): no training tasks — the
model is restored from ``--checkpoint_dir_for_init`` and either scored
against ``--validation_data`` (metrics computed from raw outputs,
reference common/evaluation_utils.py:50-97) or run forward over
``--prediction_data`` with outputs handed to the zoo module's
``PredictionOutputsProcessor``. Runs on CUDA unless ``--device cpu``.

Host-tier models (``make_host_runner``) restore their host tables from
the checkpoint and evaluate through the runner, as in the JAX package.
Device-tier sparse models (``make_sparse_runner``) are not supported:
the JAX executor has no such branch either (ROADMAP).
"""

from typing import Optional

import numpy as np
import torch

from elasticdl_tpu_torch.callbacks import apply_callbacks_to_optimizer
from elasticdl_tpu_torch.checkpoint import restore_from_dir
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.core.step import (
    build_eval_step,
    concat_eval_accumulators,
    evaluate_metrics,
)
from elasticdl_tpu_torch.core.train_state import init_train_state
from elasticdl_tpu_torch.data.batcher import batch_records, tree_map
from elasticdl_tpu_torch.data.factory import (
    create_data_reader,
    parse_data_reader_params,
)

logger = get_logger("eval_predict")


def _host_outputs(preds, real: int) -> np.ndarray:
    return preds.float().cpu().numpy()[:real]


class EvalPredictExecutor:
    def __init__(self, args, mode: str):
        if mode not in ("evaluate", "predict"):
            raise ValueError(f"mode must be evaluate|predict, got {mode}")
        self._mode = mode
        self.device = resolve_device(args.device)
        # The model's weights come from the checkpoint; the draw that
        # builds it leaves the caller's default generator as it was.
        with torch.random.fork_rng(devices=[]):
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
        if self._spec.make_sparse_runner and not self._spec.make_host_runner:
            raise NotImplementedError(
                f"{mode} of a device-tier sparse model (make_sparse_runner): "
                "the JAX package's EvalPredictExecutor has no such branch "
                "either (ROADMAP)"
            )
        data_origin = (
            args.validation_data if mode == "evaluate"
            else args.prediction_data
        )
        if not data_origin:
            raise ValueError(f"{mode} requires data")
        self._reader = create_data_reader(
            data_origin=data_origin,
            custom_reader=self._spec.custom_data_reader,
            **parse_data_reader_params(args.data_reader_params),
        )
        self._batch_size = args.minibatch_size
        self._ckpt_dir = args.checkpoint_dir_for_init
        self.state = None
        # Host-tier models: rows come back from the checkpoint into the
        # runner's tables; its eval step reads them per batch.
        self._step_runner = (
            self._spec.make_host_runner()
            if self._spec.make_host_runner else None
        )
        self._eval_step = (
            None if self._step_runner is not None else build_eval_step()
        )

    def _batches(self):
        data_mode = (
            Mode.EVALUATION if self._mode == "evaluate"
            else Mode.PREDICTION
        )
        for task_id, (shard_name, (start, count)) in enumerate(
                self._reader.create_shards().items()):
            task = Task(
                task_id=task_id, shard_name=shard_name,
                start=start, end=start + count, type=data_mode,
            )
            yield from batch_records(
                self._reader.read_records(task),
                self._batch_size,
                self._spec.dataset_fn,
                data_mode,
                self._reader.metadata,
            )

    def _restore(self, batch):
        # The optimizer as the training job built it (its schedule
        # folded in): eval/predict never apply updates, but the
        # checkpoint's opt_state leaves restore into it.
        make_optimizer = apply_callbacks_to_optimizer(
            self._spec.make_optimizer(),
            self._spec.callbacks_fn() if self._spec.callbacks_fn else [],
        )
        if self._step_runner is not None:
            self.state = self._step_runner.init_state(
                self._spec.model, make_optimizer, batch
            )
            self._eval_step = self._step_runner.eval_step()
        else:
            self.state = init_train_state(self._spec.model, make_optimizer)
        self.state = restore_from_dir(
            self.state, self._ckpt_dir,
            host_tables=getattr(self._step_runner, "host_tables", None),
        )
        logger.info(
            "Restored model version %d from %s",
            int(self.state.step), self._ckpt_dir,
        )

    def run(self) -> Optional[dict]:
        processor = self._spec.prediction_outputs_processor
        outputs_acc, labels_acc = [], []
        n_batches = 0
        for batch in self._batches():
            if self.state is None:
                self._restore(batch)
            preds = self._eval_step(self.state, batch)
            real = int(np.sum(batch["mask"]))
            n_batches += 1
            if self._mode == "evaluate":
                outputs_acc.append(_host_outputs(preds, real))
                labels_acc.append(
                    tree_map(lambda x: np.asarray(x)[:real],
                             batch["labels"])
                )
            elif processor is not None:
                processor.process(_host_outputs(preds, real), 0)
        if self.state is None:
            raise ValueError("Data produced no batches")
        if self._mode == "predict":
            return {"batches": n_batches}
        if not self._spec.eval_metrics_fn:
            raise ValueError("evaluate requires eval_metrics_fn")
        outputs, labels = concat_eval_accumulators(outputs_acc, labels_acc)
        metrics = evaluate_metrics(
            self._spec.eval_metrics_fn(), labels, outputs
        )
        logger.info("Eval metrics: %s", metrics)
        return metrics
