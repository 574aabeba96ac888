"""Shared helpers for the profiling/benchmark scripts in tools/."""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from dvbt2ll_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def bench(name, fn, *args, iters=30):
    """Time a jitted callable (compile excluded), print one line."""
    f = jax.jit(fn)
    out = jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"{name:26s} {dt*1e3:8.3f} ms   out={getattr(out, 'shape', None)}",
          flush=True)
    return out, dt
