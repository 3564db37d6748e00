"""The in-process cluster's workers each own their dense state.

Two workers of a ``MiniCluster`` run in threads of one process. Each
must train a module of its own, started from the same weights (every
JAX worker inits from the same seed and holds its own parameters); only
a host-tier model's rows are shared, as on a parameter server. Workers
that wrapped one ``nn.Module`` stepped one set of parameters with two
optimizers, and one thread's ``zero_grad(set_to_none=True)`` freed a
gradient the other thread's Adam was reading.
"""

import pytest
import torch

from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host
from elasticdl_tpu_torch.testing.cluster import MiniCluster
from elasticdl_tpu_torch.testing.data import (
    create_frappe_record_file,
    create_mnist_record_file,
    model_zoo_dir,
)
from elasticdl_tpu_torch.worker.worker import Worker

CASES = {
    "deepfm_host": ("deepfm.deepfm_host.custom_model",
                    lambda path: create_frappe_record_file(
                        path, 128, seed=8, max_id=deepfm_host.MAX_ID)),
    "mnist": ("mnist.mnist_functional.custom_model",
              lambda path: create_mnist_record_file(path, 128, seed=3)),
}


def _storages(state):
    return {p.untyped_storage().data_ptr()
            for p in state.model.parameters()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_workers_own_their_modules(tmp_path, monkeypatch, case):
    model_def, make_records = CASES[case]
    train = make_records(str(tmp_path / "train.rec"))
    initial = {}
    maybe_init = Worker._maybe_init

    def record_initial(self, batch):
        fresh = self.state is None
        maybe_init(self, batch)
        if fresh:
            # Before this worker's first step.
            initial[self._id] = {
                k: v.detach().clone()
                for k, v in self.state.model.state_dict().items()}

    monkeypatch.setattr(Worker, "_maybe_init", record_initial)
    cluster = MiniCluster(
        model_zoo=model_zoo_dir(), model_def=model_def,
        training_data=train, minibatch_size=16,
        num_minibatches_per_task=2, num_workers=2, device="cpu")
    template = {k: v.detach().clone()
                for k, v in cluster.spec.model.state_dict().items()}
    results = cluster.run()
    assert cluster.finished
    assert all(r["trained_batches"] > 0 for r in results)
    first, second = (w.state for w in cluster.workers)
    assert first.model is not second.model
    assert not _storages(first) & _storages(second)
    # Nobody trains the spec's own module: it is the template.
    assert not _storages(first) & {
        p.untyped_storage().data_ptr()
        for p in cluster.spec.model.parameters()}
    assert sorted(initial) == [0, 1]
    for wid in (0, 1):
        assert initial[wid].keys() == template.keys()
        for name, value in template.items():
            torch.testing.assert_close(initial[wid][name], value,
                                       rtol=0, atol=0)
    if case == "deepfm_host":
        # The rows stay the job's: one runner, one set of tables.
        runners = [w._step_runner for w in cluster.workers]
        assert runners[0] is runners[1]
