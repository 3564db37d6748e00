"""In-process distributed job harness (port of
elasticdl_tpu/testing/cluster.py).

Assemble a real TaskDispatcher + EvaluationService + MasterServicer,
then drive one or more of the port's Workers against it — either with
direct in-process calls or over a real localhost gRPC server — and
assert the job drains. Every worker runs on ``device`` (CUDA unless
"cpu" is given). Each worker has a spec of its own and trains its own
copy of the spec's model, made by ``run`` from ``cluster.spec.model``
(the template no worker trains, so weights loaded into it before
``run`` reach every worker); a host-tier model's runner, and so its
rows, is shared, as on a parameter server.

With ``mesh``, the workers train on it as ``worker/main.py`` wires
MeshStrategy: a device-tier sparse model through its runner built with
the mesh (row-sharded tables), any other model through a ``MeshRunner``
of the zoo module's layout extras; ``begin_resize`` opens the master's
live-resize barrier.

With ``journal_dir`` the master writes through its journal
(``master/journal.py``) and ``restart_master`` simulates a master crash
and its journal-replay recovery mid-job: over gRPC the recovered master
rebinds the same port, in process every client ``make_inprocess_client``
made is rebound. The workers, each with its own model, are untouched.

``metrics_port`` serves the master's ``MetricsPlane`` (``/metrics``,
``/traces``, ``/timeseries``, ``/alerts``, ``/profile``) until
``stop``.

With ``fault_injector`` (``chaos/interceptors.FaultInjector``) the
chaos plan reaches the master's RPCs: over gRPC through the injector's
process-wide hooks, in process through its per-RPC callbacks merged
into ``worker_callbacks``. ``checkpoint_async=False`` writes every
checkpoint on the caller's thread, so corrupt-at-save events land in
the same order against worker progress every run.
"""

import copy
import dataclasses
import threading
from typing import Dict, List, Optional

import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.core.model_spec import get_model_spec
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import SERVICE_NAME, MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.testing.in_process_master import InProcessMaster
from elasticdl_tpu_torch.worker.worker import Worker


class MiniCluster:
    """A master + N workers in one process."""

    def __init__(
        self,
        model_zoo: str,
        model_def: str,
        training_data: str = "",
        validation_data: str = "",
        prediction_data: str = "",
        num_workers: int = 1,
        minibatch_size: int = 16,
        num_minibatches_per_task: int = 2,
        num_epochs: int = 1,
        eval_steps: int = 0,
        use_rpc: bool = False,
        step_runner_factory=None,
        worker_callbacks: Optional[Dict[str, callable]] = None,
        shuffle: bool = False,
        checkpoint_dir: str = "",
        checkpoint_steps: int = 0,
        checkpoint_dir_for_init: str = "",
        fuse_task_steps: bool = False,
        metrics_report_secs: float = 0.0,
        version_report_steps: int = 1,
        device=None,
        random_seed: int = 0,
        mesh=None,
        journal_dir: str = "",
        metrics_port: Optional[int] = None,
        fault_injector=None,
        checkpoint_async: bool = True,
    ):
        self.device = resolve_device(device)
        if fault_injector is not None and not use_rpc:
            merged = dict(fault_injector.in_process_callbacks())
            for name, cb in (worker_callbacks or {}).items():
                if name in merged:
                    chaos_cb = merged[name]

                    def both(request, _user=cb, _chaos=chaos_cb):
                        _chaos(request)
                        _user(request)

                    merged[name] = both
                else:
                    merged[name] = cb
            worker_callbacks = merged
        # The model's initial weights come from random_seed, as in the
        # Local executor and worker/main.py.
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(random_seed)
            self.spec = get_model_spec(model_zoo, model_def,
                                       device=self.device)
        if mesh is not None and step_runner_factory is None:
            # The same wiring as worker/main.py's MeshStrategy.
            if self.spec.make_sparse_runner is not None:
                sparse_runner = self.spec.make_sparse_runner(
                    mesh=mesh, axis=mesh.axis_names[0])
                step_runner_factory = lambda: sparse_runner  # noqa: E731
            else:
                from elasticdl_tpu_torch.parallel.mesh_runner import (
                    make_runner_for_spec,
                )

                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(random_seed)
                    self.spec.model = self.spec.make_model(mesh)
                step_runner_factory = lambda: make_runner_for_spec(  # noqa: E731
                    self.spec, mesh)
        reader_of = lambda origin: create_data_reader(  # noqa: E731
            data_origin=origin, custom_reader=self.spec.custom_data_reader
        )
        self.train_reader = (
            reader_of(training_data) if training_data else None
        )
        self.eval_reader = (
            reader_of(validation_data) if validation_data else None
        )
        self.predict_reader = (
            reader_of(prediction_data) if prediction_data else None
        )
        # Kept for restart_master: a recovered dispatcher must be born
        # from the IDENTICAL config (shards, sizing, seed) before the
        # journal replays events into it.
        self._dispatcher_config = dict(
            training_shards=(
                self.train_reader.create_shards()
                if self.train_reader else {}
            ),
            evaluation_shards=(
                self.eval_reader.create_shards()
                if self.eval_reader else {}
            ),
            prediction_shards=(
                self.predict_reader.create_shards()
                if self.predict_reader else {}
            ),
            records_per_task=minibatch_size * num_minibatches_per_task,
            num_epochs=num_epochs,
            shuffle=shuffle,
        )
        self._eval_config = dict(
            eval_steps=eval_steps,
            eval_only=bool(validation_data and not training_data),
        )
        self.dispatcher = TaskDispatcher(**self._dispatcher_config)
        self.journal_dir = journal_dir
        self._journal = None
        if journal_dir:
            from elasticdl_tpu_torch.master.journal import MasterJournal

            self._journal = MasterJournal(journal_dir)
            self._journal.open_generation()
            self.dispatcher.attach_journal(self._journal)
        metrics_fns = (
            self.spec.eval_metrics_fn() if self.spec.eval_metrics_fn else {}
        )
        self.eval_service = EvaluationService(
            self.dispatcher, metrics_fns, **self._eval_config
        )
        if self._journal is not None:
            self.eval_service.attach_journal(self._journal)
        # Telemetry: in-process tests share ONE process registry across
        # master and workers (production is one worker per process);
        # per-worker keying comes from each client's worker_id at report
        # time. metrics_report_secs=0 → workers attach a snapshot to
        # every report so short jobs still populate the cluster view.
        from elasticdl_tpu_torch.observability import MetricsPlane

        self.metrics_plane = MetricsPlane(ttl_secs=600.0)
        self.servicer = MasterServicer(
            self.dispatcher, self.eval_service,
            metrics_plane=self.metrics_plane,
            journal=self._journal,
            generation=(
                self._journal.generation if self._journal else 0
            ),
        )
        if metrics_port is not None:
            self.metrics_plane.serve(port=metrics_port)
        # Every InProcessMaster handed out registers here so
        # restart_master can rebind them all to the recovered servicer.
        self._inprocess_clients: List[InProcessMaster] = []

        self._server = None
        self._use_rpc = use_rpc
        if use_rpc:
            from elasticdl_tpu_torch.comm.rpc import RpcServer

            self._server = RpcServer(
                "localhost:0", {SERVICE_NAME: self.servicer.handlers()}
            ).start()

        if step_runner_factory is None and self.spec.make_host_runner:
            # Host-tier default: ONE runner shared by every worker so all
            # threads train the same row stores (the PS-sharing shape);
            # a per-worker factory would silently fork the tables.
            shared_runner = self.spec.make_host_runner()
            step_runner_factory = lambda: shared_runner  # noqa: E731
        elif step_runner_factory is None and self.spec.make_sparse_runner:
            # Device-tier sparse models: tables ride the train state, so
            # a per-worker runner is only step-builder config; the
            # in-process cluster shares one (the state itself is
            # worker-owned).
            sparse_runner = self.spec.make_sparse_runner()
            step_runner_factory = lambda: sparse_runner  # noqa: E731
        task_reader = (
            self.train_reader or self.eval_reader or self.predict_reader
        )
        self.workers: List[Worker] = []
        # A spec for each worker, so the model ``run`` copies in (or a
        # resize builds) is that worker's alone.
        self._worker_specs = [dataclasses.replace(self.spec)
                              for _ in range(num_workers)]
        hook = None
        for wid in range(num_workers):
            if use_rpc:
                from elasticdl_tpu_torch.worker.master_client import (
                    MasterClient,
                )

                client = MasterClient(
                    f"localhost:{self._server.port}", worker_id=wid,
                    connect_timeout=10, retries=1,
                )
            else:
                client = self.make_inprocess_client(
                    wid, callbacks=worker_callbacks
                )
            runner = (
                step_runner_factory() if step_runner_factory else None
            )
            if wid == 0 and checkpoint_dir:
                from elasticdl_tpu_torch.checkpoint import CheckpointHook

                # Built once worker 0's runner exists so host-tier
                # tables (HostStepRunner) checkpoint alongside the state.
                hook = CheckpointHook(
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_steps=checkpoint_steps,
                    host_tables=getattr(runner, "host_tables", None),
                    async_save=checkpoint_async,
                )
            self.workers.append(
                Worker(
                    worker_id=wid,
                    master_client=client,
                    model_spec=self._worker_specs[wid],
                    data_reader=task_reader,
                    minibatch_size=minibatch_size,
                    step_runner=runner,
                    prediction_outputs_processor=(
                        self.spec.prediction_outputs_processor
                    ),
                    callbacks=(
                        self.spec.callbacks_fn()
                        if self.spec.callbacks_fn else []
                    ),
                    # One writer: worker 0 (the state is the job's).
                    checkpoint_hook=hook if wid == 0 else None,
                    checkpoint_dir_for_init=checkpoint_dir_for_init,
                    fuse_task_steps=fuse_task_steps,
                    metrics_report_secs=metrics_report_secs,
                    # SSP mapping (--get_model_steps): the master
                    # observes every N-th version only.
                    version_report_steps=version_report_steps,
                    random_seed=random_seed,
                )
            )

    def make_inprocess_client(self, worker_id: int,
                              callbacks=None) -> InProcessMaster:
        """An InProcessMaster bound to the CURRENT servicer and
        registered for restart_master's rebinding (a client bound to a
        discarded servicer would keep mutating dead state)."""
        client = InProcessMaster(
            self.servicer, worker_id=worker_id, callbacks=callbacks
        )
        self._inprocess_clients.append(client)
        return client

    def restart_master(self) -> dict:
        """Simulated master crash + journal-replay recovery (needs
        ``journal_dir``). The old dispatcher, eval service and servicer
        are DISCARDED, as a dead process would lose them: a fresh
        dispatcher is built from the identical config and
        ``recover_master_state`` replays the journal into it (the path
        ``master/main.py`` runs on a real restart). Over gRPC the server
        rebinds the same port (the workers' ride-out reconnects to it);
        in process the registered clients are rebound. Returns the
        replay stats."""
        from elasticdl_tpu_torch.comm.rpc import RpcServer
        from elasticdl_tpu_torch.master.journal import (
            MasterJournal,
            recover_master_state,
        )

        if self._journal is None:
            raise RuntimeError(
                "restart_master needs MiniCluster(journal_dir=...)"
            )
        port = self._server.port if self._server is not None else None
        if self._server is not None:
            self._server.stop(0)
            self._server = None
        self._journal.close()
        # A new handle, as a new process would open: the old one's
        # journal-side mirrors (eval round, model version) died with it,
        # and its open_generation scan would fold the file onto them a
        # second time. (The JAX seam reuses its handle.)
        self._journal = MasterJournal(self.journal_dir)
        dispatcher = TaskDispatcher(**self._dispatcher_config)
        metrics_fns = (
            self.spec.eval_metrics_fn() if self.spec.eval_metrics_fn else {}
        )
        eval_service = EvaluationService(
            dispatcher, metrics_fns, **self._eval_config
        )
        servicer = MasterServicer(
            dispatcher, eval_service,
            metrics_plane=self.metrics_plane,
            journal=self._journal,
        )
        stats = recover_master_state(
            self._journal, dispatcher, servicer=servicer,
            eval_service=eval_service,
        )
        self.dispatcher = dispatcher
        self.eval_service = eval_service
        self.servicer = servicer
        if self._use_rpc:
            self._server = RpcServer(
                f"localhost:{port}",
                {SERVICE_NAME: self.servicer.handlers()},
            ).start()
        else:
            for client in self._inprocess_clients:
                client.rebind(self.servicer)
        return stats

    def stop(self):
        """Close the journal and release the metrics endpoint (the
        server stops at the end of ``run``; the endpoint outlives it so
        tests can scrape the final cluster state first)."""
        if self._journal is not None:
            self._journal.close()
        self.metrics_plane.stop()

    def begin_resize(self, mesh, direction: str = "resize") -> int:
        """Open a live-resize barrier offering ``mesh`` to every worker
        (``master/servicer.py``; applied through the runner's ``resize``
        at each worker's next task boundary)."""
        from elasticdl_tpu_torch.parallel import reshard

        return self.servicer.begin_resize(reshard.mesh_spec(mesh),
                                          direction=direction)

    def own_models(self):
        """Give each worker that has not trained yet its own copy of the
        template's weights as they stand now (as each JAX worker holds
        its own dense state from one seed), so no two optimizers step
        one set of parameters. ``run`` calls it; a caller that drives
        ``workers`` itself calls it first."""
        for worker, spec in zip(self.workers, self._worker_specs):
            if worker.state is None:
                spec.model = copy.deepcopy(self.spec.model)

    def run(self) -> List[dict]:
        """Run all workers (threads if >1) to completion."""
        results = [None] * len(self.workers)
        self.own_models()
        if len(self.workers) == 1:
            results[0] = self.workers[0].run()
        else:
            threads = []
            for i, worker in enumerate(self.workers):
                def _run(i=i, worker=worker):
                    results[i] = worker.run()
                t = threading.Thread(target=_run, daemon=True)
                threads.append(t)
                t.start()
            for t in threads:
                t.join(timeout=300)
        if self._server is not None:
            self._server.stop(0)
        return results

    @property
    def finished(self) -> bool:
        return self.dispatcher.finished()
