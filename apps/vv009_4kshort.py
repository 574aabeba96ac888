#!/usr/bin/env python3
"""The reference example flowgraph (apps/vv009-4kshort.grc) on JAX.

    TS source (file / synthetic / stdin via the native ingest runtime)
      -> dvbt2ll_tpu transmit chain   (BB+BCH+LDPC, interleave+map,
                                       frame map + L1, pilots + IFFT + P1)
      -> gain 0.2
      -> cf32 IQ file sink

Usage:
    python apps/vv009_4kshort.py out.cf32 --frames 20
    python apps/vv009_4kshort.py out.cf32 --ts input.ts --gain 0.2
    cat input.ts | python apps/vv009_4kshort.py out.cf32 --stdin
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", help="cf32 IQ output file")
    ap.add_argument("--ts", help="MPEG-TS input file (cyclic)")
    ap.add_argument("--stdin", action="store_true",
                    help="read TS from stdin through the native ingest ring")
    ap.add_argument("--frames", type=int, default=20,
                    help="T2 frames to emit (ignored with --stdin: runs to EOF)")
    ap.add_argument("--batch", type=int, default=None,
                    help="T2 frames per jitted step (default: the smallest "
                         "phase-invariant batch, 47 for vv009)")
    ap.add_argument("--gain", type=float, default=0.2)
    ap.add_argument("--native-sink", action="store_true",
                    help="write output through the C++ async sink thread "
                         "(native/iq_sink.cc) instead of the python sink")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU backend even where a GPU "
                         "is present")
    ap.add_argument("--config",
                    help="T2Config JSON file (T2Config.to_json; enums by "
                         "name); default is the vv009-4kshort chain")
    ap.add_argument("--realtime", action="store_true",
                    help="pace emission at the config's air rate "
                         "(bandwidth-derived sample rate) - the "
                         "deployment shape; reports any deadline lag")
    args = ap.parse_args()

    import jax

    from dvbt2ll_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])

    from dvbt2ll_tpu import vv009_config
    from dvbt2ll_tpu.io import TSFileSource, synthetic_ts
    from dvbt2ll_tpu.io.sink import IQFileSink
    from dvbt2ll_tpu.pipeline import Transmitter
    from dvbt2ll_tpu.plan import min_batch_frames

    if args.config:
        from dvbt2ll_tpu.config import T2Config
        try:
            cfg = T2Config.from_json_file(args.config)
        except ValueError as e:
            raise SystemExit(f"--config {args.config}: {e}")
    else:
        cfg = vv009_config()
    if len(cfg.plps) > 1 and (args.ts or args.stdin):
        raise SystemExit(
            f"--config describes {len(cfg.plps)} PLPs but --ts/--stdin "
            "provide a single TS stream; multi-PLP muxes need one source "
            "per PLP (use the Transmitter API or synthetic mode)")
    batch = args.batch if args.batch is not None else min_batch_frames(cfg)
    drift = batch % min_batch_frames(cfg) != 0
    if drift:
        print(f"warning: batch {batch} is not a multiple of "
              f"{min_batch_frames(cfg)}; every step restarts at TS packet "
              f"phase 0, so the concatenated output is NOT a valid "
              f"continuous DVB-T2 stream", file=sys.stderr)
    tx = Transmitter(cfg, batch, strict=not drift, validate_ts=True,
                     allow_phase_drift=drift)
    n = tx.bytes_per_step

    if args.native_sink:
        from dvbt2ll_tpu.io.native_sink import NativeIQSink
        sink_cls = lambda p, gain: NativeIQSink(p, gain=gain)
    else:
        sink_cls = IQFileSink

    # --realtime: hold each step until its air-schedule deadline (the
    # pacing StreamingExecutor.run(realtime=True) applies; here inline
    # because this app drives tx.stream* directly).  The first, compiling
    # step seeds the deadline clock so compile time is not counted as
    # lag.  emitted_frame_duration counts the FEF parts stream() inserts;
    # time.perf_counter() is monotonic (an NTP/wall-clock step must not
    # stall or corrupt the schedule).
    step_t = batch * cfg.emitted_frame_duration
    pace_state = {"deadline": None, "late": 0.0}

    def pace():
        if not args.realtime:
            return
        now = time.perf_counter()
        if pace_state["deadline"] is None:
            pace_state["deadline"] = now + step_t
            return
        d = pace_state["deadline"]
        if d > now:
            time.sleep(d - now)
        else:
            pace_state["late"] = max(pace_state["late"], now - d)
        pace_state["deadline"] = d + step_t

    with sink_cls(args.output, gain=args.gain) as sink:
        if args.stdin:
            import numpy as np
            from dvbt2ll_tpu.io.ingest import TSIngest
            with TSIngest(fd=sys.stdin.fileno()) as ing:
                while True:
                    if ing.pump(1 << 20) < 0 and ing.available < 188:
                        break
                    # the native ring keeps the 187-byte carry itself; feed
                    # its pre-carried window through the public API
                    # (stream_window also inserts FEF parts when configured)
                    sink.write(tx.stream_window(ing.window(n)))
                    pace()
                print("ingest stats:", ing.stats)
                c = tx.counters
                print(f"emitted {c.frames} T2 frames, {c.samples} samples")
        else:
            src = TSFileSource(args.ts) if args.ts else None
            steps = -(-args.frames // batch)
            t0 = time.time()
            t_warm = None  # timestamp after the first (compiling) step
            per_plp = tx.bytes_per_step_per_plp
            for i in range(steps):
                if src:
                    ts = src.read(n)
                elif len(per_plp) > 1:   # multi-PLP: one stream per PLP
                    ts = [synthetic_ts(m, seed=31 * i + k)
                          for k, m in enumerate(per_plp)]
                else:
                    ts = synthetic_ts(n, seed=i)
                sink.write(tx.stream(ts))
                pace()
                if i == 0:
                    t_warm, warm_samples = time.time(), sink.samples_written
            dt = time.time() - t0
            c = tx.counters
            msg = (f"emitted {c.frames} T2 frames, {sink.samples_written} "
                   f"samples in {dt:.2f}s incl. compile")
            if steps > 1:
                rate = (sink.samples_written - warm_samples) / (
                    time.time() - t_warm)
                msg += (f"; steady state {rate/1e6:.1f} Msamp/s = "
                        f"{rate/(8e6*8/7):.1f}x the reference app's "
                        f"9.14 Msamp/s real-time rate")
            if args.realtime:
                msg += (f"; paced at the {cfg.sample_rate/1e6:.3f} Msamp/s "
                        f"air rate, worst deadline lag "
                        f"{pace_state['late']*1e3:.0f} ms")
            print(msg)


if __name__ == "__main__":
    main()
