"""``python -m elasticdl_tpu_torch`` → the CLI (``api/client.py``):
``train | evaluate | predict | serve | route | chaos | trace | clean``.

- ``serve``: the online inference server (serving/server.py).
- ``route``: the serving fleet's router (serving/router.py), in front of
  ``serve`` replicas of either package.
- ``train``: with ``--distribution_strategy Local`` a job run in-process
  by ``api/local_executor.LocalExecutor`` (``--checkpoint_dir`` saves
  it, ``--checkpoint_dir_for_init`` resumes from a checkpoint); with
  another strategy the master pod and its Services are submitted to
  kubernetes (``--image_name``), or their manifests printed when the
  ``kubernetes`` package is missing. The master pod creates the worker
  and row-service pods.
- ``evaluate`` / ``predict``: a job booting from
  ``--checkpoint_dir_for_init`` that scores ``--validation_data`` or
  hands the predictions over ``--prediction_data`` to the zoo module's
  ``PredictionOutputsProcessor`` (``api/eval_predict_executor``), in
  process under Local, else submitted as ``train`` is.
- ``clean``: delete a job's pods and Services.
- ``trace``: a traced in-process job exported as Perfetto JSON
  (observability/trace_export.py), on CUDA unless ``--device cpu``.
- ``chaos``: ``run``/``soak`` a fault plan against an in-process job
  and its fault-free twin (chaos/runner.py), on CUDA unless ``--device
  cpu``.

Local jobs run on CUDA unless ``--device cpu``. The task plane also runs
without k8s, started by hand: ``python -m
elasticdl_tpu_torch.master.main`` and ``python -m
elasticdl_tpu_torch.worker.main --master_addr HOST:PORT``.
"""

import sys

from elasticdl_tpu_torch.api.client import main

if __name__ == "__main__":
    sys.exit(main())
