"""Wall-clock timing of device work, and the persistent compile cache.

JAX dispatches asynchronously, so a timing loop is closed by
``jax.block_until_ready`` on its last output; on a local GPU that returns
when the device has finished the work.

    ms, out = timeit(fn, *args, n=10)

compiles and warms once, then reports the mean of ``n`` calls.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import jax

__all__ = ["sync", "timeit", "timeit_chain", "enable_compile_cache"]

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> None:
    """Keep compiled programs across processes. Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
    is set here; otherwise the cache lives at the fixed ``<repo>/.jax_cache``
    (a fixed path, because the path is part of the cache key)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", os.path.join(_REPO, ".jax_cache"))


def sync(out: Any) -> Any:
    """Block until every array in ``out`` is computed."""
    return jax.block_until_ready(out)


def timeit(
    fn: Callable, *args, n: int = 10, label: str | None = None, **kw
):
    """(ms_per_call, last_output) for n repeated independent calls."""
    out = sync(fn(*args, **kw))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    sync(out)
    ms = (time.perf_counter() - t0) / n * 1e3
    if label is not None:
        print(f"{label:40s} {ms:9.2f} ms", flush=True)
    return ms, out


def timeit_chain(
    step: Callable, state0: Any, inputs: list, n: int, label: str | None = None
):
    """(ms_per_step, final_state) for a state-chained loop.

    ``step(state, *inputs[i % len(inputs)]) -> (state, aux)``. The chain
    itself serialises the device work; one closing sync observes it.
    """
    state, _ = step(state0, *inputs[0])  # compile + warm
    sync(state)
    t0 = time.perf_counter()
    for i in range(n):
        state, _ = step(state, *inputs[i % len(inputs)])
    sync(state)
    ms = (time.perf_counter() - t0) / n * 1e3
    if label is not None:
        print(f"{label:40s} {ms:9.2f} ms/step", flush=True)
    return ms, state
