#!/usr/bin/env python3
"""Multi-mux demo (BASELINE.json config 5): N independent DVB-T2
channels sharded over a device mesh, each sustaining its bandwidth profile's
real-time rate.

Channels may be HETEROGENEOUS: pass --config repeatedly (one JSON per
channel group) and the pool is partitioned into per-config submeshes
(MultiMuxTransmitter) — the literal "N independent flowgraphs" analog.
With zero or one --config, all muxes share one config and one
ShardedTransmitter program.

Without --virtual the mesh spans the real devices (`jax.devices()`, e.g.
the GPUs of one host); `--virtual 8` places it on 8 virtual CPU devices
to demonstrate the sharding on a machine without them.  Multi-host
scale-out is the same `make_mesh(jax.devices(), ...)` over a
`jax.distributed` process group.

    python apps/multimux.py --mux 4 --virtual 8 --steps 3
    python apps/multimux.py --virtual 8 --steps 2 \
        --config ch_8mhz.json --config ch_1p7mhz.json
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _load_cfg(path):
    from dvbt2ll_tpu.config import T2Config
    try:
        cfg = T2Config.from_json_file(path)
    except ValueError as e:
        raise SystemExit(f"--config {path}: {e}")
    if len(cfg.plps) > 1:
        raise SystemExit(
            f"--config {path} describes {len(cfg.plps)} PLPs; this demo "
            "feeds one synthetic stream per mux - multi-PLP muxes go "
            "through the ShardedTransmitter API with per-PLP sources")
    return cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mux", type=int, default=4,
                    help="independent DVB-T2 channels (per config group)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (0 = real devices)")
    ap.add_argument("--frames-per-shard", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--config", action="append", default=[],
                    help="T2Config JSON (repeat for heterogeneous channel "
                         "groups; default vv009-4kshort)")
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}")

    import jax
    import numpy as np

    from dvbt2ll_tpu.compile_cache import enable_compile_cache
    from dvbt2ll_tpu.config import vv009_config
    from dvbt2ll_tpu.io import synthetic_ts

    enable_compile_cache()
    devices = (jax.devices("cpu")[: args.virtual] if args.virtual
               else jax.devices())
    rng = np.random.default_rng(0)

    if len(args.config) > 1:
        _run_hetero(args, devices, [_load_cfg(p) for p in args.config], rng)
        return

    from dvbt2ll_tpu.parallel import ShardedTransmitter, make_mesh
    cfg = _load_cfg(args.config[0]) if args.config else vv009_config()
    if args.mux % max(1, len(devices)) and len(devices) % args.mux:
        raise SystemExit("--mux must divide or be divisible by device count")
    mux_axis = min(args.mux, len(devices))
    mesh = make_mesh(devices, mux=mux_axis)
    stx = ShardedTransmitter(cfg, mesh, n_mux=args.mux,
                             frames_per_shard=args.frames_per_shard,
                             allow_phase_drift=True,
                             strict=False)
    nbytes = stx.bytes_per_step_per_mux
    print(f"mesh={dict(mesh.shape)} muxes={args.mux} "
          f"frames/step={stx.frames_per_step} ts_bytes/mux/step={nbytes}")

    # warm-up step: XLA compile happens here, outside the timed loop
    warm = np.stack([synthetic_ts(nbytes, seed=rng.integers(1 << 30))
                     for _ in range(args.mux)])
    jax.block_until_ready(stx.step_device(warm))

    t0 = time.perf_counter()
    total_samples = 0
    for s in range(args.steps):
        ts = np.stack([synthetic_ts(nbytes, seed=rng.integers(1 << 30))
                       for _ in range(args.mux)])
        jax.block_until_ready(stx.step_device(ts))
        total_samples += args.mux * stx.frames_per_step * cfg.samples_per_frame
    dt = time.perf_counter() - t0
    rt = cfg.sample_rate  # per-channel real-time sample rate
    print(f"{total_samples/1e6:.1f} Msamples in {dt:.2f}s = "
          f"{total_samples/dt/1e6:.1f} Msamp/s aggregate "
          f"({total_samples/dt/(rt*args.mux):.1f}x real time x {args.mux} muxes)")


def _run_hetero(args, devices, cfgs, rng):
    """One submesh per config group (heterogeneous channels)."""
    import jax
    import numpy as np

    from dvbt2ll_tpu.io import synthetic_ts
    from dvbt2ll_tpu.parallel import MultiMuxTransmitter, MuxChannel

    mm = MultiMuxTransmitter(
        [MuxChannel(cfg, n_mux=args.mux,
                    frames_per_shard=args.frames_per_shard,
                    strict=False, allow_phase_drift=True) for cfg in cfgs],
        devices=devices)
    per = mm.bytes_per_step
    for i, (ch, stx) in enumerate(zip(mm.channels, mm.transmitters)):
        print(f"channel {i}: {ch.n_devices} devices x {ch.n_mux} muxes, "
              f"{stx.frames_per_step} frames/step, "
              f"ts_bytes/mux/step={per[i]}, "
              f"{ch.cfg.sample_rate/1e6:.3f} Msamp/s real time")

    def feed():
        return [np.stack([synthetic_ts(per[i], seed=rng.integers(1 << 30))
                          for _ in range(args.mux)])
                for i in range(len(cfgs))]

    jax.block_until_ready(mm.step_device(feed()))  # warm-up/compile

    t0 = time.perf_counter()
    totals = np.zeros(len(cfgs))
    for s in range(args.steps):
        jax.block_until_ready(mm.step_device(feed()))
        for i, stx in enumerate(mm.transmitters):
            totals[i] += (args.mux * stx.frames_per_step
                          * mm.channels[i].cfg.samples_per_frame)
    dt = time.perf_counter() - t0
    agg = totals.sum()
    rt = sum(c.sample_rate * args.mux for c in cfgs)
    print(f"{agg/1e6:.1f} Msamples in {dt:.2f}s = {agg/dt/1e6:.1f} Msamp/s "
          f"aggregate ({agg/dt/rt:.1f}x the summed real-time rate of "
          f"{len(cfgs)} heterogeneous groups x {args.mux} muxes)")


if __name__ == "__main__":
    main()
