"""Prediction output sink contract (copy of
elasticdl_tpu/worker/prediction_outputs_processor.py).

Users subclass this in their model-zoo module as
``PredictionOutputsProcessor``; the ``predict`` job
(``api/eval_predict_executor.py``) calls ``process`` with each
prediction batch as a numpy array (the real rows of the batch);
typical implementations write to files, tables, or queues.
"""

import abc


class BasePredictionOutputsProcessor(abc.ABC):
    @abc.abstractmethod
    def process(self, predictions, worker_id: int):
        """Handle one batch of predictions produced by ``worker_id``."""
        raise NotImplementedError
