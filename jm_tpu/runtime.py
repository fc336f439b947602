"""Process-wide JAX settings shared by the entry points (bench.py,
chip_smoke.py and the lencod/ldecod CLIs).

Measurement entry points run on NVIDIA GPUs only: `require_gpus` stops
the process instead of letting JAX fall back to the CPU, and `card_info`
names the card and its power limit for every number they print.

The persistent compilation cache: JAX keys cached programs on the cache
path, so it must not move between runs. `JAX_COMPILATION_CACHE_DIR`
wins when set (JAX reads it itself, and nothing else is set); otherwise
the cache lives in `<checkout>/.jaxcache` (listed in .gitignore).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The compilation-cache directory this process should use."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT / ".jaxcache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    and return that directory. Call once, before the first compile."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def parallel_gpu_compile() -> str:
    """Let XLA's GPU compiler generate code on every host core (LLVM
    module compilation is single-threaded unless asked; a cold start of
    the fused P program is mostly compile time). Appends the flags to
    XLA_FLAGS unless already given, so it must run before JAX creates
    its backends. Returns the resulting XLA_FLAGS."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_force_compilation_parallelism" not in flags:
        flags = " ".join(filter(None, [
            flags, "--xla_gpu_enable_llvm_module_compilation_parallelism=true",
            f"--xla_gpu_force_compilation_parallelism={os.cpu_count() or 1}"]))
        os.environ["XLA_FLAGS"] = flags
    return flags


def require_gpus(count: int = 1, what: str = "this program"):
    """The first `count` JAX devices, which must be GPUs; exits the
    process with a message (never falls back to the CPU) otherwise."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"{what}: needs an NVIDIA GPU, but JAX found only "
                 f"{devs[0].platform} devices")
    if len(devs) < count:
        sys.exit(f"{what}: needs {count} GPUs, JAX found {len(devs)}")
    return devs[:count]


def card_info() -> str:
    """nvidia-smi's name and power limit of every card, one line each
    (a child process that does not touch JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()
