#!/usr/bin/env python3
"""Smoke test of the DVB-T2 transmitter on an NVIDIA GPU.

Drives the chain through the entry points a user calls and checks what
comes out, phase by phase:

  0. the card: ``nvidia-smi`` name and power limit, JAX version, device.
  1. goldens: ``Transmitter`` on the GPU against the reference-binary
     vectors in tests/golden_ref (FEC bits bit-exact, IQ > 100 dB SNR)
     for vv009_4kshort, 8k_normal and 32k_extended (``--all``: all 17),
     and multiplp_fef against the numpy oracle (> 100 dB).
  2. the served path at full size: synthetic TS through a pipe ->
     ``TSIngest`` -> ``Transmitter(strict=True, validate_ts=True)`` ->
     ``StreamingExecutor`` -> ``NativeIQSink``, for vv009_4kshort at batch
     235 and 32k_extended at batch 141: no TS sync errors, every sample
     in the sink file, the first frames > 100 dB against the oracle, and
     the throughput on the host clock.

``--multi`` runs only the four-GPU path: ``ShardedTransmitter`` on a
(mux=2, frame=2) mesh bit-identical to the sequential ``Transmitter`` on
one GPU, with no collective in its optimized HLO, and a
``MultiMuxTransmitter`` running two configs on 2 + 2 GPUs.

Any failed check exits non-zero.  Only a run where every phase passed
prints, as its last line, {"ok": true, "device": {"platform": ...,
"kind": ..., "count": ...}}.  A process without a GPU fails at once.

Usage: python chip_smoke.py [--all] [--multi]
"""
import functools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from bench import _named_config  # noqa: E402
from dvbt2ll_tpu import refmodel  # noqa: E402
from dvbt2ll_tpu.compile_cache import enable_compile_cache  # noqa: E402
from dvbt2ll_tpu.io import synthetic_ts  # noqa: E402

MIN_SNR_DB = 100.0
GOLDEN_DIR = os.path.join(REPO, "tests", "golden_ref")
GOLDENS = ["vv009_4kshort", "8k_normal", "32k_extended"]
ALL_GOLDENS = sorted(f[:-4] for f in os.listdir(GOLDEN_DIR)
                     if f.endswith(".npz"))
#: (config, batch): batches that are whole multiples of the config's
#: min_batch_frames (47), so every step continues the TS packet phase.
SERVED = [("vv009_4kshort", 235), ("32k_extended", 141)]
SERVED_STEPS = 8  # timed steps, after one warm-up step that compiles


class SmokeFailure(Exception):
    """A check of this script failed."""


def log(msg: str) -> None:
    print(msg, flush=True)


def snr_db(ref, x) -> float:
    ref = np.asarray(ref, np.complex128).ravel()
    x = np.asarray(x, np.complex128).ravel()
    if ref.shape != x.shape:
        raise SmokeFailure(f"IQ shape {x.shape} != reference {ref.shape}")
    err = float(np.sum(np.abs(x - ref) ** 2))
    if err == 0:
        return float("inf")
    return 10 * np.log10(float(np.sum(np.abs(ref) ** 2)) / err)


def require_snr(what: str, ref, x) -> float:
    snr = snr_db(ref, x)
    if not snr > MIN_SNR_DB:  # also catches NaN
        raise SmokeFailure(f"{what}: IQ SNR {snr:.2f} dB <= {MIN_SNR_DB}")
    return snr


def load_golden(name: str):
    """(cfg, ts, stage2 frame bits, stage5 IQ (frames, samples)) of one
    reference-binary golden."""
    cfg = _named_config(name)
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        nframes = int(z["nframes"])
        ts = synthetic_ts(int(z["ts_bytes"]), seed=int(z["ts_seed"]))
        bits = np.unpackbits(z["stage2_bits_packed"])[
            : int(z["stage2_count"])].reshape(-1, cfg.ldpc_frame_bits)
        iq = z["stage5_iq"].reshape(nframes, cfg.samples_per_frame)
    return cfg, ts, bits, iq


def check_golden(name: str, bits, iq, ref_bits, ref_iq) -> float:
    """FEC bits must equal the golden's bit for bit and IQ must clear
    MIN_SNR_DB; returns the SNR, raises SmokeFailure otherwise."""
    bits = np.asarray(bits)
    if bits.shape != ref_bits.shape or not np.array_equal(bits, ref_bits):
        raise SmokeFailure(f"{name}: FEC bits differ from the golden")
    return require_snr(name, ref_iq, iq)


def phase_card(jax) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    d = jax.devices()[0]
    log(f"jax {jax.__version__}: {len(jax.devices())} x {d.device_kind} "
        f"({d.platform})")


def phase_goldens(jax, names) -> None:
    import jax.numpy as jnp
    from dvbt2ll_tpu.pipeline import Transmitter, bb_and_fec

    for name in names:
        cfg, ts, ref_bits, ref_iq = load_golden(name)
        t0 = time.perf_counter()
        tx = Transmitter(cfg, ref_iq.shape[0], strict=False)
        iq = tx(ts)
        t_iq = time.perf_counter() - t0
        window = jnp.asarray(np.concatenate([np.zeros(187, np.uint8), ts]))
        bits = jax.jit(functools.partial(bb_and_fec, tx.plan.plps[0]))(
            window)
        snr = check_golden(name, bits, iq, ref_bits, ref_iq)
        log(f"golden {name}: {ref_iq.shape[0]} frames, FEC bit-exact "
            f"({ref_bits.size} bits), IQ {snr:.2f} dB, "
            f"compile+first step {t_iq:.1f} s, "
            f"tail {'planar' if tx._planar_tail else 'complex'}")

    name = "multiplp_fef"
    cfg = _named_config(name)
    tx = Transmitter(cfg, cfg.t2_frames, strict=False)
    streams = [synthetic_ts(n, seed=40 + i)
               for i, n in enumerate(tx.bytes_per_step_per_plp)]
    t0 = time.perf_counter()
    iq = tx(streams)
    t_iq = time.perf_counter() - t0
    ref = refmodel.transmit_chain(cfg, streams, cfg.t2_frames)
    snr = require_snr(name, ref, iq)
    log(f"oracle {name}: {cfg.t2_frames} frames, IQ {snr:.2f} dB, "
        f"compile+first step {t_iq:.1f} s")


def _feed(write_fd: int, stop: threading.Event) -> None:
    """Write a cyclic synthetic TS into the pipe until stopped or the
    reader goes away."""
    buf = memoryview(synthetic_ts(188 * 4096, seed=7).tobytes())
    try:
        while not stop.is_set():
            off = 0
            while off < len(buf):
                off += os.write(write_fd, buf[off:])
    except OSError:
        pass
    finally:
        os.close(write_fd)


def phase_served(name: str, batch: int, steps: int = SERVED_STEPS) -> None:
    from dvbt2ll_tpu.executor import StreamingExecutor
    from dvbt2ll_tpu.io.ingest import TSIngest
    from dvbt2ll_tpu.io.native_sink import NativeIQSink
    from dvbt2ll_tpu.pipeline import Transmitter

    cfg = _named_config(name)
    tx = Transmitter(cfg, batch, strict=True, validate_ts=True)
    first = []

    rfd, wfd = os.pipe()
    stop = threading.Event()
    feeder = threading.Thread(target=_feed, args=(wfd, stop), daemon=True)
    feeder.start()
    ing = TSIngest(fd=rfd, capacity=4 * (tx.bytes_per_step + 187))
    ing.start_thread()

    def source(nbytes):
        while True:
            w = ing.window(nbytes, allow_stuffing=False)
            if w is not None:
                if not first:
                    first.append(w[187:].copy())
                return w[187:]
            time.sleep(0.0005)

    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}.cf32")
            sink = NativeIQSink(path, gain=1.0)
            ex = StreamingExecutor(tx, source=source, sink=sink)
            t0 = time.perf_counter()
            ex.step()   # step 0: compiles
            ex.flush()
            t_first = time.perf_counter() - t0
            stats = ex.run(steps)
            sink.close()
            ing_stats = ing.stats
            frames0 = np.fromfile(path, np.complex64,
                                  count=2 * cfg.samples_per_frame)
            written = os.path.getsize(path) // 8
    finally:
        stop.set()
        ing.close()
        os.close(rfd)
        feeder.join(timeout=10)

    total = (steps + 1) * batch * cfg.samples_per_frame
    if tx.counters.sync_errors or ing_stats["sync_errors"]:
        raise SmokeFailure(
            f"served {name}: sync errors (transmitter "
            f"{tx.counters.sync_errors}, ingest {ing_stats['sync_errors']})")
    if sink.samples_written != total or written != total:
        raise SmokeFailure(
            f"served {name}: sink holds {written} samples "
            f"({sink.samples_written} written), expected {total}")
    ref = refmodel.transmit_chain(cfg, first[0], 2)
    snr = require_snr(f"served {name} step 0", ref, frames0)
    rate = steps * batch * cfg.samples_per_frame / stats["wall_clock_seconds"]
    log(f"served {name}: batch {batch}, {steps + 1} steps, "
        f"{total} samples in the sink, sync_errors 0, "
        f"first 2 frames {snr:.2f} dB, compile+first step {t_first:.1f} s")
    log(f"served {name}: {rate / 1e6:.3f} Msamples/s over {steps} steps "
        f"= {rate / cfg.sample_rate:.1f} x its air rate "
        f"({cfg.sample_rate / 1e6:.6f} Msamples/s)")


def phase_multi(jax) -> None:
    from dvbt2ll_tpu.config import vv009_config
    from dvbt2ll_tpu.parallel import (MultiMuxTransmitter, MuxChannel,
                                      ShardedTransmitter, make_mesh)
    from dvbt2ll_tpu.parallel.sharding import find_collectives, halo_windows
    from dvbt2ll_tpu.pipeline import Transmitter
    from dvbt2ll_tpu.plan import min_batch_frames

    devs = jax.devices()
    if len(devs) < 4:
        raise SmokeFailure(f"--multi needs 4 GPUs, found {len(devs)}")
    devs = devs[:4]

    cfg = vv009_config()
    fps = min_batch_frames(cfg)
    stx = ShardedTransmitter(cfg, make_mesh(devs, mux=2), n_mux=2,
                             frames_per_shard=fps)
    n = stx.bytes_per_step_per_mux
    ts = np.stack([synthetic_ts(2 * n, seed=60 + c) for c in range(2)])
    t0 = time.perf_counter()
    outs = [np.asarray(stx.step_device(ts[:, k * n:(k + 1) * n]))
            for k in range(2)]   # (mux, frame shard, fps, samples, 2)
    t_sharded = time.perf_counter() - t0
    w = halo_windows(ts[:, :n], np.zeros((2, 187), np.uint8), 2)
    args = [stx._mesh_put(w, stx._in_specs[0]),
            stx._mesh_put(np.zeros((2, 2), np.int32), stx._in_specs[-1])]
    hits = find_collectives(stx._sharded.lower(*args).compile().as_text())
    if hits:
        raise SmokeFailure(f"sharded step has collectives: {sorted(set(hits))}")

    per = n // 2   # one shard's fresh bytes
    for c in range(2):
        tx = Transmitter(cfg, fps, strict=True)
        for k in range(2):
            for s in range(2):
                off = k * n + s * per
                seq = np.asarray(tx.step_device(ts[c, off:off + per]))
                if not np.array_equal(outs[k][c, s], seq):
                    raise SmokeFailure(
                        f"sharded step {k} mux {c} shard {s} differs from "
                        f"the sequential Transmitter")
    log(f"multi sharded: vv009_4kshort on a (mux=2, frame=2) mesh of 4 "
        f"GPUs, 2 steps x {2 * 2 * fps} frames bit-identical to the "
        f"sequential Transmitter, 0 collectives, "
        f"compile+2 steps {t_sharded:.1f} s")

    cfgs = [cfg, _named_config("8k_normal")]
    mm = MultiMuxTransmitter(
        [MuxChannel(cfg=c, n_devices=2, frames_per_shard=min_batch_frames(c))
         for c in cfgs], devices=devs)
    groups = [sorted(d.id for d in m.devices.flat) for m in mm.meshes]
    if sorted(sum(groups, [])) != sorted(d.id for d in devs):
        raise SmokeFailure(f"multimux groups {groups} do not cover 4 GPUs")
    mts = [synthetic_ts(b, seed=70 + i)[None]
           for i, b in enumerate(mm.bytes_per_step)]
    got = mm(mts)
    for i, (c, stx_i) in enumerate(zip(cfgs, mm.transmitters)):
        tx = Transmitter(c, stx_i.plan.batch_frames, strict=True)
        per = tx.bytes_per_step
        seq = np.concatenate([tx(mts[i][0, s * per:(s + 1) * per])
                              for s in range(stx_i.frame_shards)])
        if not np.array_equal(got[i][0], seq):
            raise SmokeFailure(f"multimux channel {i} differs from the "
                               f"sequential Transmitter")
    log(f"multi multimux: vv009_4kshort on GPUs {groups[0]} and 8k_normal "
        f"on GPUs {groups[1]}, both bit-identical to the sequential "
        f"Transmitter")


def main(argv) -> int:
    import jax

    enable_compile_cache()
    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {d.platform} "
              f"({d.device_kind})", file=sys.stderr)
        return 1
    phase_card(jax)
    t0 = time.perf_counter()
    if "--multi" in argv:
        phase_multi(jax)
    else:
        phase_goldens(jax, ALL_GOLDENS if "--all" in argv else GOLDENS)
        for name, batch in SERVED:
            phase_served(name, batch)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
