"""MeshRunner: train/eval steps over a device mesh (port of
elasticdl_tpu/parallel/mesh_runner.py, one-device meshes).

The JAX runner jits one SPMD program per step with the batch sharded
over ``dp`` and the optimizer state ZeRO-sharded. In this slice every
entry of the mesh is one device (``parallel/mesh.py``), so the state
lives whole on that device and the steps are ``core/step.py``'s, run on
the model the mesh was built into (a ``TransformerLM(cfg, mesh)`` runs
ring attention over ``sp``). What the runner adds is the reference's
sync semantics (SURVEY.md §2.7):

- sync SGD ``grads_to_wait`` → ``accum_steps`` gradient accumulation:
  the optimizer applies every ``accum_steps`` calls, with the mean of
  the window's gradients;
- async staleness LR modulation → ``staleness_modulation=True``:
  microbatch j of a window of k is weighted 1/(k - j), normalised by the
  harmonic sum (the reference's lr/staleness).

BatchNorm statistics move with every microbatch of an accumulation
window, independently of the delayed optimizer apply, and keep their
old values after a batch with padded rows, as in the JAX runner
(``core/step.py``'s guard).

Steps are memoised per (kind, loss function). Nothing reads a value
back from the card: the accumulation window's count is a host int.
Waiting for the parallel slice: the data axis, ``resize``,
``place_state``, ZeRO placement of the optimizer state, the sharding
rules and multi-host.
"""

from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.core import step as step_lib
from elasticdl_tpu_torch.core.train_state import TrainState, init_train_state
from elasticdl_tpu_torch.parallel import mesh as mesh_lib


class MeshRunner:
    """The Worker ``step_runner`` interface over a one-device Mesh."""

    def __init__(self, mesh: Optional[mesh_lib.Mesh] = None,
                 accum_steps: int = 1, staleness_modulation: bool = False):
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.accum_steps = accum_steps
        self.staleness_modulation = staleness_modulation
        # Keyed on the loss function OBJECT (the memo pins it alive; an
        # id() could be recycled). The accumulation path is not memoised:
        # it carries a window across calls.
        self._step_memo: Dict = {}

    def _memoized(self, kind, fn_key, builder):
        key = (kind, fn_key)
        step = self._step_memo.get(key)
        if step is None:
            step = builder()
            self._step_memo[key] = step
        return step

    def init_state(self, model, tx, example_batch=None,
                   seed: int = 0) -> TrainState:
        """The train state of ``model`` (moved to the mesh's device) with
        the optimizer ``tx(params)``. ``example_batch`` is accepted for
        the JAX signature: a torch module already has its shapes."""
        model = model.to(self.mesh.device)
        return init_train_state(model, tx, seed=seed)

    def train_step(self, loss_fn: Callable) -> Callable:
        """``(state, batch) -> (state, metrics)``; with ``accum_steps``
        > 1 each call is one microbatch of the window."""
        if self.accum_steps > 1:
            return self._accum_train_step(loss_fn)
        return self._memoized("train", loss_fn,
                              lambda: step_lib.build_train_step(loss_fn))

    def _accum_train_step(self, loss_fn: Callable) -> Callable:
        accum_steps = self.accum_steps
        if self.staleness_modulation:
            def weight_of(count):
                return 1.0 / (accum_steps - count)
            norm = float(sum(1.0 / (accum_steps - j)
                             for j in range(accum_steps)))
        else:
            def weight_of(count):
                return 1.0
            norm = float(accum_steps)
        call_loss = step_lib._call_loss(loss_fn)
        apply = step_lib.build_apply_gradients()
        window = {"grads": None, "count": 0}

        def micro_step(state, batch):
            # The statistics move with the microbatch (guarded), the
            # weights at the window's apply.
            loss = step_lib._loss_and_grads(call_loss, state, batch)
            grads = step_lib._take_grads(state)
            w = weight_of(window["count"])
            acc = window["grads"]
            window["grads"] = (
                {k: w * g for k, g in grads.items()} if acc is None
                else {k: acc[k] + w * g for k, g in grads.items()})
            window["count"] += 1
            if window["count"] >= accum_steps:
                mean = {k: g / norm for k, g in window["grads"].items()}
                state = apply(state, mean, 1.0)
                window["grads"], window["count"] = None, 0
            return state, {"loss": loss}

        return micro_step

    def train_multi_step(self, loss_fn: Callable) -> Callable:
        """A whole task's minibatches (stacked with a leading T dim) in
        one call (``core.step.build_multi_step``); the plain path only."""
        return self._memoized("multi", loss_fn,
                              lambda: step_lib.build_multi_step(loss_fn))

    def eval_step(self) -> Callable:
        return self._memoized("eval", None, step_lib.build_eval_step)

    def place_state(self, state):
        raise NotImplementedError(
            "MeshRunner.place_state waits for the parallel slice")

    def resize(self, new_mesh, state=None):
        raise NotImplementedError(
            "MeshRunner.resize waits for the parallel slice")


def make_runner_for_spec(spec, mesh: Optional[mesh_lib.Mesh] = None,
                         accum_steps: int = 1, **kwargs) -> MeshRunner:
    """A MeshRunner for a ModelSpec. The JAX version wires the spec's
    sharding extras and data axis, which wait for the parallel slice."""
    del spec
    return MeshRunner(mesh=mesh, accum_steps=accum_steps, **kwargs)
