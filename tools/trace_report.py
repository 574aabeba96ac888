"""Trace N transmit steps on the GPU and report where the device time goes.

Runs the Transmitter's jitted step under ``jax.profiler``, reads the
device planes (``/device:GPU:*``) of the written XSpace, and prints

  * the device busy time per step and the idle share of the window
    (1 - union of kernel intervals / window),
  * the time per pipeline stage, from the ``jax.named_scope`` each op
    was traced under (fec, ldpc, map, frame_build, ofdm, iq_out; read
    from the optimized HLO's op metadata),
  * the 25 most expensive ops.

XLA's command buffers (CUDA graphs) are turned off for the traced
process, so that every kernel is its own trace event with its HLO op
name; the busy and idle figures are of that program.

Usage: python tools/trace_report.py [batch] [steps] [config] [logdir]
  config: vv009_4kshort (default) | 8k_normal | 32k_extended | ...
  logdir: where the trace and the step's optimized HLO are kept
          (default: a new temporary directory)
"""
import collections
import glob
import os
import re
import sys
import tempfile

from _common import jax  # adds repo root to sys.path

import numpy as np

#: pipeline named scopes, innermost first (ldpc sits inside fec)
STAGES = ("ldpc", "fec", "map", "frame_build", "ofdm", "iq_out")

_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]+)"',
                    re.M)


def hlo_scopes(hlo_text: str) -> dict:
    """Instruction name -> pipeline stage, from optimized HLO text."""
    out = {}
    for name, op_name in _INSTR.findall(hlo_text):
        parts = op_name.split("/")
        for stage in STAGES:
            if stage in parts:
                out[name] = stage
                break
    return out


def device_events(xspace_path: str):
    """[(op name, start_ns, duration_ns)] of every event on the GPU
    planes' stream lines.  The op name is the event's ``hlo_op`` stat
    where the profiler records one, else the event (kernel) name."""
    from jax.profiler import ProfileData

    events = []
    for plane in ProfileData.from_file(xspace_path).planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            # per-stream kernel lines only: derived summary lines (XLA
            # Modules / Ops / Steps) would count the same time twice
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                stats = dict(e.stats)
                op = str(stats.get("hlo_op") or e.name)
                events.append((op, e.start_ns, e.duration_ns))
    return events


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    spans = sorted((s, s + d) for _, s, d in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def stage_times(events, scopes: dict) -> collections.Counter:
    """Device ns per pipeline stage ("other" where no scope matched)."""
    agg = collections.Counter()
    for op, _, d in events:
        agg[scopes.get(op, "other")] += d
    return agg


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    name = sys.argv[3] if len(sys.argv) > 3 else "vv009_4kshort"
    logdir = (sys.argv[4] if len(sys.argv) > 4
              else tempfile.mkdtemp(prefix="dvbt2ll_trace_"))
    # before the backend starts: one trace event per kernel
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()

    import jax.numpy as jnp

    from bench import _named_config
    from dvbt2ll_tpu.io import synthetic_ts
    from dvbt2ll_tpu.pipeline import Transmitter

    cfg = _named_config(name)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"trace_report reads GPU planes; found {dev}")
    tx = Transmitter(cfg, batch, strict=False, allow_phase_drift=True)
    ws = [jnp.asarray(np.concatenate(
        [np.zeros(187, np.uint8), synthetic_ts(n, seed=3 + i)]))
        for i, n in enumerate(tx.bytes_per_step_per_plp)]
    args = (ws if len(ws) > 1 else ws[0], jnp.int32(0))
    jax.block_until_ready(tx._step(*args))  # compile outside the trace
    hlo = tx._step.lower(*args).compile().as_text()
    scopes = hlo_scopes(hlo)
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, f"{name}_{batch}.hlo.txt"), "w") as f:
        f.write(hlo)

    with jax.profiler.trace(logdir):
        out = None
        for _ in range(steps):
            out = tx._step(*args)
        jax.block_until_ready(out)
    path = sorted(glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True))[-1]
    events = device_events(path)
    if not events:
        from jax.profiler import ProfileData
        for plane in ProfileData.from_file(path).planes:
            print(f"plane {plane.name}: lines "
                  f"{[line.name for line in plane.lines][:12]}")
        raise SystemExit(f"no GPU kernel events in {path}")
    t0 = min(s for _, s, _ in events)
    t1 = max(s + d for _, s, d in events)
    busy = busy_ns(events)
    print(f"trace: {path}")
    print(f"{name} batch {batch}, {steps} steps on {dev.device_kind}: "
          f"device busy {busy / steps / 1e6:.3f} ms/step, "
          f"window {(t1 - t0) / steps / 1e6:.3f} ms/step, "
          f"idle share {1 - busy / (t1 - t0):.3f}")
    total = sum(d for _, _, d in events)
    for stage, d in stage_times(events, scopes).most_common():
        print(f"stage {stage:12s} {d / steps / 1e6:8.3f} ms/step "
              f"{100 * d / total:5.1f}%")
    agg = collections.Counter()
    for op, _, d in events:
        agg[op[:64]] += d
    for op, d in agg.most_common(25):
        print(f"{d / steps / 1e6:8.3f} ms/step {100 * d / total:5.1f}%  "
              f"{op}  [{scopes.get(op, '-')}]")


if __name__ == "__main__":
    main()
