"""A/B of the two OFDM tails on the current device, end to end.

For each (config, batch) both jitted steps run on the same
device-resident input, in the order complex, planar, planar, complex
(``rounds`` blocks of ``iters`` steps each), and the script prints each
tail's ms/step and Msamples/s with the SNR of its first two frames
against the numpy oracle.  select_step_iq's STEP_TAIL entry for a
platform should name the tail that wins here in every cell.

  complex  transmit_step_iq: jnp.fft.ifft, GI concat, stack(re, im)
  planar   transmit_step_iq_planar: f32 4-step einsums (ops/ifft4.py)

Usage: python tools/ab_tail.py [config:batch ...]
  default: vv009_4kshort:256 8k_normal:256 32k_extended:128
"""
import functools
import sys
import time

from _common import jax

import jax.numpy as jnp
import numpy as np

from bench import _named_config
from dvbt2ll_tpu import refmodel
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.pipeline import transmit_step_iq, transmit_step_iq_planar
from dvbt2ll_tpu.plan import build_plan

TAILS = {"complex": transmit_step_iq, "planar": transmit_step_iq_planar}


def snr_db(ref, x):
    ref = np.asarray(ref, np.complex128).ravel()
    x = np.asarray(x, np.complex128).ravel()
    err = np.sum(np.abs(x - ref) ** 2)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-30))


def ab(name, batch, iters=20, rounds=2):
    cfg = _named_config(name)
    plan = build_plan(cfg, batch, strict=False)
    ts = synthetic_ts(plan.ts_bytes_in, seed=5)
    w = jnp.asarray(np.concatenate([np.zeros(187, np.uint8), ts]))
    fi = jnp.int32(0)
    ref = refmodel.transmit_chain(cfg, ts, 2)
    fns, res = {}, {}
    for tail, step in TAILS.items():
        t0 = time.perf_counter()
        fns[tail] = jax.jit(functools.partial(step, plan))
        out = np.asarray(fns[tail](w, fi))
        compile_s = time.perf_counter() - t0
        iq = out[:2].reshape(2, -1, 2)
        res[tail] = {"snr": snr_db(ref, iq[..., 0] + 1j * iq[..., 1]),
                     "compile_s": compile_s, "times": []}
    order = ["complex", "planar", "planar", "complex"] * rounds
    for tail in order:
        f = fns[tail]
        jax.block_until_ready(f(w, fi))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(w, fi)
        jax.block_until_ready(out)
        res[tail]["times"].append((time.perf_counter() - t0) / iters)
    for tail, r in res.items():
        t = np.asarray(r["times"])
        rate = batch * cfg.samples_per_frame / t.mean()
        print(f"{name} batch {batch} {tail:8s} {t.mean() * 1e3:8.3f} ms/step"
              f" (min {t.min() * 1e3:.3f}, max {t.max() * 1e3:.3f}) "
              f"{rate / 1e6:9.1f} Msamples/s  SNR {r['snr']:.2f} dB  "
              f"compile {r['compile_s']:.1f} s", flush=True)
    return res


def main():
    cells = sys.argv[1:] or ["vv009_4kshort:256", "8k_normal:256",
                             "32k_extended:128"]
    d = jax.devices()[0]
    print(f"device {d.device_kind} ({d.platform})", flush=True)
    for cell in cells:
        name, batch = cell.split(":")
        ab(name, int(batch))


if __name__ == "__main__":
    main()
