"""Single-T2-frame latency benchmark (BASELINE metric: T2-frame latency).

Measures the device time to produce ONE T2 frame (batch_frames=1) for the
BASELINE configs, against each config's real-time frame duration.
Usage: python tools/bench_latency.py
"""
import sys
import time

from _common import jax

import jax.numpy as jnp
import numpy as np


def main():
    from bench import _named_config
    from dvbt2ll_tpu.io import synthetic_ts
    from dvbt2ll_tpu.pipeline import Transmitter

    names = sys.argv[1:] or ("vv009_4kshort", "8k_normal", "32k_extended",
                             "multiplp_fef")
    configs = {name: _named_config(name) for name in names}
    for name, cfg in configs.items():
        tx = Transmitter(cfg, 1, strict=False)
        ws = [jnp.asarray(np.concatenate(
                  [np.zeros(187, np.uint8), synthetic_ts(n, seed=3 + i)]))
              for i, n in enumerate(tx.bytes_per_step_per_plp)]
        w = ws if len(ws) > 1 else ws[0]
        fi = jnp.int32(0)
        jax.block_until_ready(tx._step(w, fi))  # compile
        iters = 50
        t0 = time.perf_counter()
        for _ in range(iters):
            out = tx._step(w, fi)
        jax.block_until_ready(out)
        lat_ms = (time.perf_counter() - t0) / iters * 1e3
        print(f"{name:22s} frame latency {lat_ms:7.3f} ms   "
              f"(frame duration {cfg.frame_duration*1e3:7.3f} ms, "
              f"{cfg.frame_duration*1e3/lat_ms:6.1f}x real time)",
              flush=True)


if __name__ == "__main__":
    main()
