"""Sustained-streaming benchmark: the full runtime, minutes at a time.

The step benches (bench.py) isolate device throughput with pre-staged
inputs; THIS tool measures the number the BASELINE "sustained real-time"
phrasing actually names: ``StreamingExecutor`` + the native TS ingest
ring (native/ts_ingest.cc, fed through a real pipe) + the native async
IQ sink (native/iq_sink.cc), run for >= 60 s with the transmitter's
``TxCounters`` reported (frames/s, samples/s, sync errors, realtime
margin vs the reference app's 9.143 Msamp/s).  Match: GNU Radio
runtime steady-state streaming (SURVEY.md section 3.2).

Roles (each one process, sequential):
  full    - complete host loop on the default device: ingest ring ->
            jitted step -> device->host IQ fetch -> native sink.
  device  - same ingest ring + jitted step, but the IQ stays on device
            and a per-step block_until_ready provides backpressure
            (the deployment shape for a device feeding an on-device/RF
            consumer; what remains host-bound is the TS upload).
  cpu     - the 'full' role pinned to the host CPU backend: every byte
            moves through every runtime component at memory speed.
  paced   - the 'full' loop driven at the CONFIG PROFILE's real-time
            rate (StreamingExecutor realtime pacing): the deployment
            contract of a transmitter.  Reports the cumulative deadline
            lag; paced_ok=true means every T2 frame left the full stack
            on its air schedule (>= 1x real time sustained).

Usage: python tools/bench_sustained.py [role] [seconds] [config] [batch]
       defaults: all three roles, 60 s each, vv009_4kshort.
"""
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_RATE = 8e6 * 8 / 7  # the reference app's sample rate (BASELINE.md)


def _feeder(write_fd: int, stop: threading.Event, chunk_packets: int = 4096):
    """Write a cyclic synthetic TS into the pipe as fast as it drains.
    One pre-built buffer is rewritten so generation never bottlenecks
    the ring (the payload content does not affect timing: the chain is
    data-independent)."""
    from dvbt2ll_tpu.io import synthetic_ts

    buf = memoryview(synthetic_ts(188 * chunk_packets, seed=7).tobytes())
    try:
        while not stop.is_set():
            off = 0
            while off < len(buf):  # os.write may be partial on a pipe
                off += os.write(write_fd, buf[off:])
    except (BrokenPipeError, OSError):
        pass
    finally:
        try:
            os.close(write_fd)
        except OSError:
            pass


def _build(config: str, batch):
    from bench import _named_config
    from dvbt2ll_tpu.pipeline import Transmitter
    from dvbt2ll_tpu.plan import min_batch_frames

    cfg = _named_config(config)
    if batch is None:
        # smallest phase-invariant batch: every step continues the TS
        # packet phase, so the emitted stream is a VALID continuous mux
        batch = min_batch_frames(cfg)
    # validate_ts so the reported sync_errors counter actually CHECKS the
    # stream (it only increments under validate_ts; without it the JSON
    # would claim a verified-clean stream unconditionally).  The
    # Transmitter asks select_step_iq for the default device's tail.
    tx = Transmitter(cfg, batch, strict=True, validate_ts=True)
    return cfg, tx


def run_role(role: str, seconds: float, config: str, batch=None) -> dict:
    import jax
    import numpy as np

    from dvbt2ll_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = jax.devices("cpu")[0] if role == "cpu" else None
    ctx = jax.default_device(device) if device is not None else _nullctx()
    with ctx:
        cfg, tx = _build(config, batch)
        n = tx.bytes_per_step

        from dvbt2ll_tpu.executor import StreamingExecutor
        from dvbt2ll_tpu.io.ingest import TSIngest
        from dvbt2ll_tpu.io.native_sink import NativeIQSink

        rfd, wfd = os.pipe()
        stop = threading.Event()
        feeder = threading.Thread(target=_feeder, args=(wfd, stop),
                                  daemon=True)
        feeder.start()
        sink_dir = tempfile.mkdtemp(prefix="dvbt2ll_sustained_")
        sink_path = os.path.join(sink_dir, f"sustained_{role}.cf32")
        ing = TSIngest(fd=rfd, capacity=1 << 24)
        ing.start_thread()

        def source(nbytes):
            # the ring's window carries its own 187-byte overlap; the
            # Transmitter keeps the stream state, so feed it fresh bytes
            while True:
                w = ing.window(nbytes, allow_stuffing=False)
                if w is not None:
                    return w[187:]
                time.sleep(0.0005)

        try:
            if role == "device":
                # IQ stays on device; waiting for each step provides
                # backpressure
                jax.block_until_ready(tx.step_window(np.concatenate(
                    [np.zeros(187, np.uint8), source(n)])))  # compile
                tx.counters.__init__()
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    w = np.concatenate([tx._carries[0], source(n)])
                    jax.block_until_ready(tx.step_window(w))
                wall = time.perf_counter() - t0
                sink_stats = {}
            elif role == "paced":
                sink = NativeIQSink(sink_path, gain=0.2)
                ex = StreamingExecutor(tx, source=source, sink=sink,
                                       realtime=True)
                ex.step()  # compile outside the clock
                ex.flush()
                tx.counters.__init__()
                # emitted_frame_duration: FEF parts count toward airtime
                frame_t = (tx.plan.batch_frames
                           * cfg.emitted_frame_duration)
                n_steps = max(1, int(seconds / frame_t))
                t0 = time.perf_counter()
                ex.run(n_steps)
                sink.flush()
                wall = time.perf_counter() - t0
                lag = wall - n_steps * frame_t  # >0: fell behind the air
                sink_stats = {"sink_samples": sink.samples_written,
                              "producer_stalls": sink.producer_stalls,
                              "paced_steps": n_steps,
                              "paced_lag_s": round(lag, 3),
                              # one step of slack: the pipelined drain of
                              # the final step legitimately trails its
                              # enqueue; anything more means underrun
                              "paced_ok": bool(lag <= frame_t)}
                sink.close()
            else:
                sink = NativeIQSink(sink_path, gain=0.2)
                ex = StreamingExecutor(tx, source=source, sink=sink)
                ex.step()  # compile outside the clock
                tx.counters.__init__()
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    ex.step()
                ex.flush()
                sink.flush()
                wall = time.perf_counter() - t0
                sink_stats = {"sink_samples": sink.samples_written,
                              "producer_stalls": sink.producer_stalls}
                sink.close()
            ing_stats = ing.stats  # before close() frees the native ring
        finally:
            stop.set()
            ing.close()
            if os.path.exists(sink_path):
                os.unlink(sink_path)
            os.rmdir(sink_dir)

        c = tx.counters
        rate = c.samples / wall
        return {
            "role": role, "config": config, "device": role if role == "cpu"
            else str(jax.devices()[0]), "batch": tx.plan.batch_frames,
            "sustained_s": round(wall, 1), "steps": c.steps,
            "t2_frames": c.frames, "frames_per_s": round(c.frames / wall, 1),
            "msamp_per_s": round(rate / 1e6, 2),
            "x_realtime": round(rate / REF_RATE, 1),
            # the configured channel's OWN air rate (bandwidth-derived,
            # pilotgenp1insert_cc_impl.cc:1179-1201): vv009 is the 1.7 MHz
            # profile at 1.845 Ms/s - the rate a deployment of THIS config
            # must sustain; x_realtime above keeps the reference app's
            # 9.143 Ms/s USRP clock as the cross-config yardstick
            "profile_msamp_per_s": round(cfg.sample_rate / 1e6, 3),
            "x_realtime_profile": round(rate / cfg.sample_rate, 2),
            "ts_mbyte_per_s": round(c.ts_bytes / wall / 1e6, 1),
            "sync_errors": c.sync_errors,
            "ingest": ing_stats, **sink_stats,
        }


class _nullctx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def main():
    role = sys.argv[1] if len(sys.argv) > 1 else "all"
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
    config = sys.argv[3] if len(sys.argv) > 3 else "vv009_4kshort"
    batch = int(sys.argv[4]) if len(sys.argv) > 4 else None
    roles = ["device", "full", "cpu"] if role == "all" else [role]
    for r in roles:
        print(json.dumps(run_role(r, seconds, config, batch)), flush=True)


if __name__ == "__main__":
    main()
