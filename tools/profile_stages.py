"""Per-stage wall-clock profile of a transmit chain on the current device.

Times each pipeline stage as its own jitted program to rank hot spots.
Usage: python tools/profile_stages.py [batch] [iters] [config]
  config: vv009_4kshort (default) | 8k_normal | 32k_extended
"""
import sys

from _common import bench, jax

import jax.numpy as jnp
import numpy as np

from bench import _named_config
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu import pipeline as P
from dvbt2ll_tpu.pipeline import Transmitter


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    cfg = _named_config(sys.argv[3] if len(sys.argv) > 3
                        else "vv009_4kshort")
    tx = Transmitter(cfg, batch, strict=False, allow_phase_drift=True)
    pp = tx.plan.plps[0]
    n = tx.bytes_per_step
    ts = np.concatenate([np.zeros(187, np.uint8), synthetic_ts(n)])
    w = jnp.asarray(ts)
    fi = jnp.int32(0)
    print(f"device {jax.devices()[0].device_kind}, batch {batch}", flush=True)

    bits, t1 = bench("bb_and_fec", lambda a: P.bb_and_fec(pp, a), w,
                     iters=iters)
    cells, t2 = bench("map_cells", lambda a: P.map_cells(pp, a), bits,
                      iters=iters)
    payload, t3 = bench("ti_payload",
                        lambda a: P.ti_payload(pp, a, batch), cells,
                        iters=iters)
    grids, t4 = bench("build_frames",
                      lambda a, i: P.build_frames(tx.plan, a, i), payload,
                      fi, iters=iters)
    out, t5 = bench("modulate", lambda a: P.modulate(tx.plan, a), grids,
                    iters=iters)
    _, tot = bench("FULL step", lambda a, i: tx._step(a, i), w, fi,
                   iters=iters)
    ssum = t1 + t2 + t3 + t4 + t5
    print(f"{'sum-of-stages':18s} {ssum*1e3:8.2f} ms   "
          f"(full={tot*1e3:.2f} ms, fusion gain={ssum/tot:.2f}x)")
    rate = batch * cfg.samples_per_frame / tot
    print(f"throughput {rate/1e6:.1f} Msamp/s")


if __name__ == "__main__":
    main()
