"""Job image builder (port of elasticdl_tpu/api/image_builder.py; reference
elasticdl/python/elasticdl/image_builder.py:12-80).

Packages the port (``elasticdl_tpu_torch``) + the user's model zoo into a
container image the master/worker pods run. Mirrors the reference flow —
generate a Dockerfile, assemble a build context, `docker build` +
`docker push` — but with the docker SDK gated: on hosts without docker
(dev machines, CI), the context directory + Dockerfile are still
produced so any external builder (kaniko, buildah, `docker build`
elsewhere) can finish the job.

The image installs what the port imports (torch, numpy, grpcio), never
jax or flax. The port's CUDA kernels are built at their first use with
``nvcc`` (``ops/_build.py``) and its row store with ``g++``
(``native/row_store.py``), so the base image must carry CUDA's toolkit
(``nvcc`` under ``/usr/local/cuda``) and a C++ compiler; the build
caches (``ops/_build/``, ``native/_build/``) are left out of the context.
The default base image is configurable per cluster.
"""

import os
import shutil
import tempfile
import uuid
from typing import Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("image_builder")

_DOCKERFILE_TEMPLATE = """\
FROM {base_image}

RUN pip install --no-cache-dir torch numpy grpcio \\
    {extra_pypi}
COPY elasticdl_tpu_torch /opt/elasticdl_tpu_torch/elasticdl_tpu_torch
COPY model_zoo /opt/elasticdl_tpu_torch/model_zoo
ENV PYTHONPATH=/opt/elasticdl_tpu_torch:$PYTHONPATH
WORKDIR /opt/elasticdl_tpu_torch
"""


def _framework_root() -> str:
    import elasticdl_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(elasticdl_tpu_torch.__file__)
    ))


def _ignore_build_outputs(directory, names):
    """Caches and build outputs stay out of the image: the kernels and the
    row store build on the pod's own toolchain at first use."""
    skip = set(shutil.ignore_patterns("__pycache__", "*.pyc", "*.so",
                                      "*.o")(directory, names))
    if os.path.basename(directory) in ("ops", "native") and "_build" in names:
        skip.add("_build")
    return skip


def generate_dockerfile(
    base_image: str = "python:3.12-slim",
    extra_pypi_packages: str = "",
) -> str:
    return _DOCKERFILE_TEMPLATE.format(
        base_image=base_image, extra_pypi=extra_pypi_packages or ""
    )


def prepare_build_context(
    model_zoo: str,
    context_dir: Optional[str] = None,
    base_image: str = "python:3.12-slim",
    extra_pypi_packages: str = "",
) -> str:
    """Assemble a docker build context: framework package + model zoo +
    Dockerfile. Returns the context directory path."""
    ctx = context_dir or tempfile.mkdtemp(prefix="edl_tpu_ctx_")
    os.makedirs(ctx, exist_ok=True)
    pkg_src = os.path.join(_framework_root(), "elasticdl_tpu_torch")
    shutil.copytree(
        pkg_src,
        os.path.join(ctx, "elasticdl_tpu_torch"),
        ignore=_ignore_build_outputs,
        dirs_exist_ok=True,
    )
    shutil.copytree(
        model_zoo,
        os.path.join(ctx, "model_zoo"),
        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"),
        dirs_exist_ok=True,
    )
    with open(os.path.join(ctx, "Dockerfile"), "w") as f:
        f.write(generate_dockerfile(base_image, extra_pypi_packages))
    return ctx


def build_and_push_docker_image(
    model_zoo: str,
    docker_image_repository: str = "",
    base_image: str = "python:3.12-slim",
    extra_pypi_packages: str = "",
    tag: Optional[str] = None,
    push: bool = True,
    client=None,
) -> str:
    """Build (and optionally push) the job image; returns the image name.

    Reference parity: image_builder.build_and_push_docker_image. When the
    docker SDK/daemon is unavailable the context is still prepared and the
    image name returned with a warning — the caller can hand the context
    to an external builder (``prepare_build_context`` output path is
    logged).
    """
    tag = tag or uuid.uuid4().hex[:12]
    repo = docker_image_repository.rstrip("/")
    image = f"{repo}/elasticdl_tpu_torch:{tag}" if repo else (
        f"elasticdl_tpu_torch:{tag}"
    )
    ctx = prepare_build_context(
        model_zoo, base_image=base_image,
        extra_pypi_packages=extra_pypi_packages,
    )
    if client is None:
        try:
            import docker

            client = docker.APIClient()
        except Exception:  # SDK missing or daemon unreachable
            # Keep the context: it is the hand-off artifact for an
            # external builder (kaniko/buildah/docker elsewhere).
            logger.warning(
                "docker unavailable; build context prepared at %s for an "
                "external builder (image name %s)", ctx, image,
            )
            return image
    try:
        for line in client.build(path=ctx, tag=image, rm=True,
                                 decode=True):
            if "stream" in line:
                text = line["stream"].strip()
                if text:
                    logger.info(text)
            if "error" in line:
                raise RuntimeError(
                    f"docker build failed: {line['error']}"
                )
        if push and repo:
            for line in client.push(image, stream=True, decode=True):
                if "error" in line:
                    raise RuntimeError(
                        f"docker push failed: {line['error']}"
                    )
    finally:
        # The image now holds the content; a leftover context per submit
        # would fill /tmp on long-lived CI hosts.
        shutil.rmtree(ctx, ignore_errors=True)
    return image
