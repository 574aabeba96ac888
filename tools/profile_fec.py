"""Time the FEC front end against the whole step on the current device.

Each part runs as its own jitted program at the step's shapes:

  bb_and_fec      TS window -> LDPC frame bits (BB framing, CRC-8,
                  scrambling, BCH matmul, LDPC)
  ldpc            BCH codewords -> LDPC parity (qc_ldpc_parity, the
                  static slice-XOR schedule bb_and_fec runs)
  step            the Transmitter's whole jitted step

and the LDPC share of the step is ldpc / step.

Usage: python tools/profile_fec.py [batch] [iters] [config]
"""
import sys

from _common import bench, jax

import jax.numpy as jnp
import numpy as np

from bench import _named_config
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.pipeline import Transmitter, bb_and_fec, qc_ldpc_parity


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    name = sys.argv[3] if len(sys.argv) > 3 else "vv009_4kshort"
    cfg = _named_config(name)
    tx = Transmitter(cfg, batch, strict=False, allow_phase_drift=True)
    pp = tx.plan.plps[0]
    w = jnp.asarray(np.concatenate(
        [np.zeros(187, np.uint8), synthetic_ts(pp.ts_bytes_in)]))
    fi = jnp.int32(0)
    print(f"{name} batch {batch} on {jax.devices()[0].device_kind}: "
          f"F={pp.fec_frames} nbch={cfg.nbch} "
          f"plen={cfg.ldpc_parity_bits} "
          f"schedule={sum(len(e) for e in pp.ldpc_cols)} slices", flush=True)

    bits, t_fec = bench("bb_and_fec", lambda a: bb_and_fec(pp, a), w,
                        iters=iters)
    nbch_bits = bits[:, :cfg.nbch]
    _, t_ldpc = bench(
        "ldpc", lambda a: qc_ldpc_parity(pp.ldpc_cols, cfg.q_ldpc,
                                         cfg.ldpc_parity_bits, a),
        nbch_bits, iters=iters)
    if len(tx.plan.plps) == 1:
        _, t_step = bench("step", lambda a, i: tx._step(a, i), w, fi,
                          iters=iters)
        print(f"ldpc share of the step {t_ldpc / t_step:.3f}, "
              f"bb_and_fec share {t_fec / t_step:.3f}; "
              f"ldpc {pp.fec_frames * cfg.ldpc_parity_bits / t_ldpc / 1e9:.2f}"
              f" Gbit/s of parity", flush=True)


if __name__ == "__main__":
    main()
