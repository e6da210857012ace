"""Device timing: a host clock around work that ends in block_until_ready.

JAX dispatch is asynchronous, so a timing that does not wait for the result
measures the enqueue.  Both helpers warm up first (compilation is set-up,
not step time) and wait on every timed result.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def time_calls(fn: Callable, args, iters: int = 20, warmup: int = 2) -> float:
    """Median seconds per call of fn(*args)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_stateful(step: Callable, state, iters: int = 20, warmup: int = 2):
    """Mean seconds per call of state = step(state) over `iters` chained
    calls (a decode loop threading its KV cache), and the final state.
    step may donate its state: each call's result is the next call's
    argument."""
    for _ in range(warmup):
        state = step(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / iters, state


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the card, read by a child
    process that stays off JAX."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def enable_compile_cache(checkout: str) -> str:
    """Persistent compile cache for bench.py and chip_smoke.py.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set here.  Otherwise the cache goes to the fixed `.jax_cache/` of
    the checkout (gitignored): a fixed path, because the path is part of
    what a later run looks up.  Returns the directory in use."""
    import os

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(os.path.abspath(checkout), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
