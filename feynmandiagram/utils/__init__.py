"""Utilities: profiling hooks, distributed bring-up, device set-up, cost metrics."""
from .profiling import trace, lowered_cost
from .distributed import initialize_distributed
from .device import (compile_cache_dir, enable_compile_cache, require_gpu,
                     require_gpu_or_exit, gpu_name_and_power_limit,
                     NoGpuError)
