"""Scaling mechanics of the frame-sharded transmit step on virtual CPU
devices (BASELINE.md ">=80% scaling efficiency" bar).

Three measurements, each a subprocess so the virtual device count can be
set before JAX imports:

  A. Strong scaling on a virtual CPU mesh: the SAME 16 T2 frames split
     over 1/2/4/8 frame shards, wall-clock per step.  XLA's CPU backend
     already multithreads one device's computation across the host's
     cores, so the curve saturates at the core count - it bounds the
     sharding mechanism's overhead, it cannot show device scaling.
  B. HLO collective audit: compile the 8-device sharded step and count
     inter-device ops (all-reduce/all-gather/collective-permute/
     all-to-all/reduce-scatter) in the optimized HLO.  The steady-state
     claim "linear by construction" rests on this being ZERO: with no
     cross-device ops, N chips run N disjoint programs and per-chip
     throughput is the single-chip number (bit-identity across shard
     counts is tests/test_sharding.py).
  C. Multi-host (DCN): the same 8-device step as 1 process x 8 virtual
     devices vs 2 jax.distributed processes x 4 devices (localhost
     coordinator, real wire protocol), wall-clock over the same steps;
     efficiency = t_single / t_multihost.

Usage: python tools/bench_scaling.py            # orchestrate all three
"""
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TOTAL_FRAMES = 16
STEPS = 10
N_MH_PROCS = 2
MH_DEV = 4


def _env(n_local_devices):
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count="
                        f"{n_local_devices}").strip()
    # pure-CPU subprocesses: no worker opens an accelerator
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _jax_setup():
    import jax

    from dvbt2ll_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    return jax


def _build(n_shards, devices, frames_per_shard):
    from dvbt2ll_tpu.config import vv009_config
    from dvbt2ll_tpu.io import synthetic_ts
    from dvbt2ll_tpu.parallel import ShardedTransmitter, make_mesh

    cfg = vv009_config()
    mesh = make_mesh(devices[:n_shards], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1,
                             frames_per_shard=frames_per_shard,
                             strict=False, allow_phase_drift=True)
    ts = synthetic_ts(stx.bytes_per_step_per_mux, seed=3)[None]
    return cfg, stx, ts


def _timed_steps(jax, stx, ts, steps):
    out = stx.step_device(ts)
    jax.block_until_ready(out)        # compile
    t0 = time.perf_counter()
    for _ in range(steps):
        out = stx.step_device(ts)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def role_strong(n_shards):
    jax = _jax_setup()
    cfg, stx, ts = _build(n_shards, jax.devices("cpu"),
                          TOTAL_FRAMES // n_shards)
    dt = _timed_steps(jax, stx, ts, STEPS)
    rate = STEPS * TOTAL_FRAMES * cfg.samples_per_frame / dt
    print(json.dumps({"role": "strong", "shards": n_shards,
                      "wall_s": round(dt, 4),
                      "msamp_s": round(rate / 1e6, 2)}), flush=True)


def role_hlo_audit():
    jax = _jax_setup()
    import numpy as np

    _, stx, ts = _build(8, jax.devices("cpu"), TOTAL_FRAMES // 8)
    # reproduce step_device's staging to lower the jitted sharded fn
    from dvbt2ll_tpu.parallel.sharding import halo_windows
    w = halo_windows(ts, stx._carries[:, 0], stx.frame_shards)
    fidx = np.zeros((1, stx.frame_shards), np.int32)
    args = [stx._mesh_put(w, stx._in_specs[0]),
            stx._mesh_put(fidx, stx._in_specs[-1])]
    hlo = stx._sharded.lower(*args).compile().as_text()
    from dvbt2ll_tpu.parallel.sharding import find_collectives
    hits = find_collectives(hlo)
    print(json.dumps({"role": "hlo_audit", "devices": 8,
                      "hlo_ops": hlo.count("\n"),
                      "collectives": len(hits),
                      "kinds": sorted(set(hits))}), flush=True)


def role_mh_single():
    jax = _jax_setup()
    cfg, stx, ts = _build(N_MH_PROCS * MH_DEV, jax.devices("cpu"),
                          TOTAL_FRAMES // (N_MH_PROCS * MH_DEV))
    dt = _timed_steps(jax, stx, ts, STEPS)
    rate = STEPS * TOTAL_FRAMES * cfg.samples_per_frame / dt
    print(json.dumps({"role": "mh_single", "wall_s": round(dt, 4),
                      "msamp_s": round(rate / 1e6, 2)}), flush=True)


def role_mh_worker(pid, coordinator):
    jax = _jax_setup()
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=N_MH_PROCS, process_id=pid)
    assert len(jax.devices()) == N_MH_PROCS * MH_DEV
    cfg, stx, ts = _build(N_MH_PROCS * MH_DEV, jax.devices(),
                          TOTAL_FRAMES // (N_MH_PROCS * MH_DEV))
    dt = _timed_steps(jax, stx, ts, STEPS)
    rate = STEPS * TOTAL_FRAMES * cfg.samples_per_frame / dt
    if pid == 0:
        print(json.dumps({"role": "mh_multi", "procs": N_MH_PROCS,
                          "wall_s": round(dt, 4),
                          "msamp_s": round(rate / 1e6, 2)}), flush=True)
    jax.distributed.shutdown()


def _run(args, n_dev):
    r = subprocess.run([sys.executable, __file__] + args, env=_env(n_dev),
                       timeout=900, capture_output=True, text=True)
    if r.returncode:
        sys.stderr.write(r.stdout + r.stderr)
        raise SystemExit(f"worker {args} failed rc={r.returncode}")
    line = [l for l in r.stdout.splitlines() if l.startswith("{")][-1]
    return json.loads(line)


def orchestrate():
    results = {"host_cores": os.cpu_count()}

    strong = [_run(["--role", "strong", str(n)], n) for n in (1, 2, 4, 8)]
    t1 = strong[0]["wall_s"]
    for s in strong:
        s["speedup"] = round(t1 / s["wall_s"], 2)
    results["strong"] = strong

    results["hlo_audit"] = _run(["--role", "hlo-audit"], 8)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    single = _run(["--role", "mh-single"], N_MH_PROCS * MH_DEV)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--role", "mh-worker", str(pid),
         coordinator], env=_env(MH_DEV), stdout=subprocess.PIPE, text=True)
        for pid in range(N_MH_PROCS)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit(f"multihost workers failed: {outs}")
    multi = json.loads([l for l in outs[0].splitlines()
                        if l.startswith("{")][-1])
    results["multihost"] = {
        "single_process": single, "two_process": multi,
        "efficiency": round(single["wall_s"] / multi["wall_s"], 3)}
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    if "--role" not in sys.argv:
        orchestrate()
    else:
        role = sys.argv[sys.argv.index("--role") + 1]
        if role == "strong":
            role_strong(int(sys.argv[sys.argv.index("--role") + 2]))
        elif role == "hlo-audit":
            role_hlo_audit()
        elif role == "mh-single":
            role_mh_single()
        else:
            role_mh_worker(int(sys.argv[sys.argv.index("--role") + 2]),
                           sys.argv[sys.argv.index("--role") + 3])
