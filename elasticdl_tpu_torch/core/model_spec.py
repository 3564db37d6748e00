"""The model-zoo user contract and its loader (port of
elasticdl_tpu/core/model_spec.py).

A user model is a Python module in the model-zoo directory defining, by
name:

- ``custom_model(device=None)`` -> a ``torch.nn.Module`` on ``device``
  whose ``forward`` takes the feature tree (and, to use dropout, a
  ``generator`` keyword: the train state's CPU generator); a mesh-aware
  model also takes ``mesh`` (``ModelSpec.make_model``);
- ``loss(labels, predictions, mask)`` -> scalar tensor loss (``mask``
  weights padded rows of the final partial batch; a 2-argument loss is
  called without it);
- ``optimizer(**kw)`` -> a factory ``params -> torch.optim.Optimizer``
  (where the JAX contract returns an optax transformation: a torch
  optimizer needs the parameters at construction);
- ``dataset_fn(records, mode, metadata)`` -> ``(features, labels)``
  numpy trees for a list of decoded records;
- ``eval_metrics_fn()`` -> dict of metric name -> fn(labels, predictions),
- optional: ``callbacks()``, ``custom_data_reader(**kwargs)``,
  ``make_host_runner()`` -> an ``embedding.host_engine.HostStepRunner``
  for host-tier models, ``make_sparse_runner()`` -> an
  ``embedding.device_sparse.DeviceSparseRunner`` for device-tier sparse
  models (the Local executor then trains through the runner, a host
  runner first), ``PredictionOutputsProcessor``: a class (a
  ``worker.prediction_outputs_processor.BasePredictionOutputsProcessor``)
  whose instance, ``ModelSpec.prediction_outputs_processor``, the
  ``predict`` job hands each batch of predictions,
  ``param_sharding_rules()`` -> ``(name_regex, PartitionSpec)`` pairs and
  ``batch_sharding_rule(path, leaf) -> PartitionSpec``: the layout
  extras ``parallel/mesh_runner.make_runner_for_spec`` reads.
"""

import importlib.util
import inspect
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional


def load_module(module_file):
    """Import a python file by path."""
    spec = importlib.util.spec_from_file_location(module_file, module_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_model_zoo_module(model_zoo: str, model_def: str):
    """Resolve ``pkg.module.func`` under the model-zoo dir and import it;
    returns ``(module, func_name)``."""
    parts = model_def.split(".")
    if len(parts) < 2:
        raise ValueError(
            f"model_def must be like 'module.function', got {model_def!r}"
        )
    module_rel = os.path.join(*parts[:-1]) + ".py"
    module_file = os.path.join(model_zoo, module_rel)
    if not os.path.exists(module_file):
        raise FileNotFoundError(f"No model module at {module_file}")
    return load_module(module_file), parts[-1]


def _get_spec_value(module, name, required=False):
    value = getattr(module, name, None)
    if value is None and required:
        raise ValueError(
            f"Model zoo module is missing required symbol {name!r}"
        )
    return value


def _takes(fn: Callable, name: str) -> bool:
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _build_model(model_fn: Callable, device, **kwargs):
    """``model_fn(device=device, **kwargs)`` when it takes a device, else
    ``model_fn(**kwargs).to(device)``."""
    if _takes(model_fn, "device"):
        return model_fn(device=device, **kwargs)
    model = model_fn(**kwargs)
    return model.to(device) if device is not None else model


@dataclass
class ModelSpec:
    """Everything loaded from the user's model-zoo module."""

    model: Any
    model_fn_name: str
    loss: Callable
    optimizer_fn: Callable
    dataset_fn: Callable
    eval_metrics_fn: Optional[Callable] = None
    callbacks_fn: Optional[Callable] = None
    custom_data_reader: Optional[Callable] = None
    prediction_outputs_processor: Any = None
    module: Any = None
    # Host-tier models (embedding/host_engine.py): factory returning a
    # HostStepRunner, which holds the host tables and pulls and applies
    # their rows around each step.
    make_host_runner: Optional[Callable] = None
    # Device-tier sparse models (embedding/device_sparse.py): factory
    # returning a DeviceSparseRunner, which owns the HBM tables and
    # their lookup and row-update kernels.
    make_sparse_runner: Optional[Callable] = None
    # Layout extras for the MeshRunner (parallel/mesh_runner.py);
    # dp-only models need neither.
    param_sharding_rules: Optional[Callable] = None
    batch_sharding_rule: Optional[Callable] = None
    model_fn: Optional[Callable] = None
    device: Any = None

    def make_optimizer(self, **kwargs) -> Callable:
        """The zoo's optimizer factory: ``params -> Optimizer``."""
        return self.optimizer_fn(**kwargs)

    @property
    def mesh_aware(self) -> bool:
        """Whether ``custom_model`` takes a ``mesh`` (``make_model``
        then builds a model for that mesh)."""
        return self.model_fn is not None and _takes(self.model_fn, "mesh")

    def make_model(self, mesh=None):
        """Build the model anew, passing the mesh when ``custom_model``
        accepts a ``mesh`` keyword (mesh-aware models run ring attention;
        others ignore the mesh). The device is passed as at load."""
        if self.model_fn is None:
            return self.model
        if mesh is not None and _takes(self.model_fn, "mesh"):
            return _build_model(self.model_fn, self.device, mesh=mesh)
        return _build_model(self.model_fn, self.device)


def get_model_spec(
    model_zoo: str,
    model_def: str,
    dataset_fn: str = "dataset_fn",
    loss: str = "loss",
    optimizer: str = "optimizer",
    eval_metrics_fn: str = "eval_metrics_fn",
    callbacks: str = "callbacks",
    custom_data_reader: str = "custom_data_reader",
    device=None,
    prediction_outputs_processor: str = "PredictionOutputsProcessor",
) -> ModelSpec:
    """Load the user module, resolve the contract symbols by name and
    build the model on ``device``."""
    module, model_fn_name = load_model_zoo_module(model_zoo, model_def)
    model_fn = getattr(module, model_fn_name, None)
    if model_fn is None:
        raise ValueError(
            f"{model_def}: function {model_fn_name!r} not found in module"
        )
    processor_cls = getattr(module, prediction_outputs_processor, None)
    return ModelSpec(
        model=_build_model(model_fn, device),
        model_fn_name=model_fn_name,
        loss=_get_spec_value(module, loss, required=True),
        optimizer_fn=_get_spec_value(module, optimizer, required=True),
        dataset_fn=_get_spec_value(module, dataset_fn, required=True),
        eval_metrics_fn=_get_spec_value(module, eval_metrics_fn),
        callbacks_fn=_get_spec_value(module, callbacks),
        custom_data_reader=_get_spec_value(module, custom_data_reader),
        prediction_outputs_processor=(
            processor_cls() if processor_cls is not None else None
        ),
        module=module,
        make_host_runner=_get_spec_value(module, "make_host_runner"),
        make_sparse_runner=_get_spec_value(module, "make_sparse_runner"),
        param_sharding_rules=_get_spec_value(
            module, "param_sharding_rules"),
        batch_sharding_rule=_get_spec_value(module, "batch_sharding_rule"),
        model_fn=model_fn,
        device=device,
    )
