"""Process set-up shared by the entry points (CLI, bench.py,
benchmarks.py, chip_smoke.py): the persistent compile cache and the
accelerator check."""

from __future__ import annotations

import os
import subprocess

import jax


def checkout_dir() -> str:
    """Root of the source tree this package was imported from."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else a fixed directory inside
    the checkout (the path is part of the cache key, so it must not
    move between runs)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(checkout_dir(), ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir(). When
    JAX_COMPILATION_CACHE_DIR is set JAX already reads it, and no other
    directory is set here; a directory the caller already configured is
    kept too. Returns the directory in use."""
    current = jax.config.jax_compilation_cache_dir
    if "JAX_COMPILATION_CACHE_DIR" in os.environ or current:
        return current or compile_cache_dir()
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


class NoAcceleratorError(RuntimeError):
    """JAX found no GPU; a measurement must not fall back to the CPU."""


def require_gpu(devices=None):
    """The GPU devices JAX sees; raises NoAcceleratorError otherwise."""
    devices = jax.devices() if devices is None else devices
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "nothing"
        raise NoAcceleratorError(f"no GPU: JAX's default backend is {found}")
    return devices


def device_record(devices=None) -> dict:
    """{"platform", "kind", "count"} of the devices as JAX reports them."""
    devices = jax.devices() if devices is None else devices
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def gpu_name_and_power_limit() -> str:
    """nvidia-smi's `name, power.limit` line per card, from a child
    process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
