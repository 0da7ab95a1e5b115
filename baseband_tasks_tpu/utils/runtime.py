"""Run-time setup shared by the entry scripts (chip_smoke.py, bench.py,
tools/bench_full.py): the persistent compile cache, the device check and
the device description every result line carries.

Nothing here runs at package import; each entry script calls what it
needs before its first compilation.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["configure_compile_cache", "require_gpu", "device_summary",
           "gpu_name_and_power_limit"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def configure_compile_cache(root):
    """Point JAX's persistent compile cache at ``<root>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set, in which case JAX
    already uses that directory and nothing is changed.  Returns the
    directory in use.  The path is fixed (no temp name, PID or time),
    so a later run from the same checkout finds the cache again."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(n=1):
    """The first ``n`` devices, which must be GPUs; raises
    ``SystemExit`` otherwise (a measurement never falls back to the
    CPU)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    if len(devs) < n:
        raise SystemExit(f"need {n} GPUs, JAX sees {len(devs)}")
    return devs[:n]


def device_summary():
    """``{"platform", "kind", "count"}`` of JAX's devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (first card), or ``"not available"``."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines \
        else "not available"
