"""Runtime configuration helpers."""

from __future__ import annotations

import os
import subprocess

# The checkout this package runs from; run-time caches live inside it
# (listed in .gitignore), never in the user's home.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_COMPILE_CACHE = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else a fixed directory in
    the checkout.  The path is part of the cache key, so it never depends
    on a temp name, a PID or the time."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache at compile_cache_dir().

    The PBS pipeline is one big traced loop; cold compiles dominate small
    runs. The persistent cache makes repeat runs of the CLI, tests, and
    benchmarks near-instant to warm up. Returns the directory used.
    """
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def nvidia_smi() -> str:
    """Each card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them.  Runs
    as a child process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Raise unless the first device is a CUDA GPU.  A measurement that
    finds no card fails; it never falls back to the CPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise RuntimeError(f"needs a CUDA GPU, JAX found {found!r}")


def device_info() -> dict:
    """What every result line names: the platform, device kind and count
    as JAX reports them, plus the card's name and power limit on a GPU."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs)}
    if devs[0].platform == "gpu":
        info["gpu"] = nvidia_smi()
    return info
