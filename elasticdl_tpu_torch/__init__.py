"""elasticdl_tpu_torch — the PyTorch/CUDA port of ``elasticdl_tpu``.

The JAX package stays the reference; this package mirrors its layout
and names so each module's counterpart is found at the same path. It
imports ``torch`` and never ``jax``, and nothing of ``elasticdl_tpu``:
where it needs a helper from there it keeps its own copy.

Importing the package imports no framework (PEP 562 lazy attributes,
as in ``elasticdl_tpu/__init__.py``). Entry points run on CUDA unless
the caller passes ``device="cpu"``; with no GPU and no such request
they raise.
"""

__version__ = "0.1.0"

_LAZY = {
    "TransformerLM": ("elasticdl_tpu_torch.models.transformer",
                      "TransformerLM"),
    "TransformerConfig": ("elasticdl_tpu_torch.models.transformer",
                          "TransformerConfig"),
    "generate": ("elasticdl_tpu_torch.models.transformer", "generate"),
    "flash_attention": ("elasticdl_tpu_torch.ops.flash_attention",
                        "flash_attention"),
    "get_model_spec": ("elasticdl_tpu_torch.core.model_spec",
                       "get_model_spec"),
    "ModelSpec": ("elasticdl_tpu_torch.core.model_spec", "ModelSpec"),
    "TrainState": ("elasticdl_tpu_torch.core.train_state", "TrainState"),
    "MeshRunner": ("elasticdl_tpu_torch.parallel.mesh_runner",
                   "MeshRunner"),
    "make_mesh": ("elasticdl_tpu_torch.parallel.mesh", "make_mesh"),
    "LocalExecutor": ("elasticdl_tpu_torch.api.local_executor",
                      "LocalExecutor"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'elasticdl_tpu_torch' has no attribute {name!r}"
    )
