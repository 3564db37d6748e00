from elasticdl_tpu_torch.utils.profiler import Profiler  # noqa: F401
