"""Device set-up shared by the scripts that run on the GPU.

- ``compile_cache_dir`` / ``enable_compile_cache``: JAX's persistent
  compilation cache.  ``$JAX_COMPILATION_CACHE_DIR`` wins when set;
  otherwise the cache lives at a fixed path inside the checkout
  (``<repo>/.jax_cache``, ignored by git), so that one process reuses what
  an earlier one compiled.  The path is part of the cache key, so it is
  never temporary or derived from a pid or a time.
- ``require_gpu`` / ``require_gpu_or_exit``: refuse to measure or check
  anything on another platform.
- ``gpu_name_and_power_limit``: the card's name and power limit, read with
  ``nvidia-smi`` in a child process that stays off JAX.
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Mapping, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


class NoGpuError(RuntimeError):
    """Raised when JAX's default device is not an NVIDIA GPU."""


def compile_cache_dir(env: Optional[Mapping[str, str]] = None) -> str:
    """Where the persistent compilation cache lives."""
    env = os.environ if env is None else env
    return env.get(CACHE_ENV) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and return the path.  Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return ``jax.devices()``, or raise ``NoGpuError`` if the default
    device is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's default device is {devices[0].platform!r} "
            f"({devices[0].device_kind}); this script measures and checks "
            "the GPU path only")
    return devices


def require_gpu_or_exit(prog: str):
    """``require_gpu()`` for a script's entry point: on another platform,
    say why on stderr and exit with status 2."""
    try:
        return require_gpu()
    except NoGpuError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        raise SystemExit(2)


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each card, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
