"""Multi-host (DCN) execution check: N real jax.distributed processes.

BASELINE.json demands >=80% scaling efficiency at N>=2 hosts; SURVEY.md
section 5.8 specifies single-controller JAX over DCN.  This tool actually
EXERCISES that leg: it runs one
ShardedTransmitter step as

  1. a single process with 8 virtual CPU devices (ground truth), then
  2. two jax.distributed processes x 4 virtual CPU devices each
     (localhost coordinator - real DCN wire protocol, separate address
     spaces, global mesh spanning both processes),

and asserts the gathered 2-process output is BIT-IDENTICAL to the
single-process result.  The chain is collective-free in steady state, so
multi-host adds only input placement (make_array_from_callback per
process) and the coordination channel - which this run proves.

Usage: python tools/dryrun_multihost.py            # orchestrate + verify
       (internal: --role single|worker, see below)
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROCS = 2
DEV_PER_PROC = 4
TS_SEED = 77


def _env(n_local_devices):
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count={n_local_devices}"
                        ).strip()
    # pure-CPU subprocesses: no worker opens an accelerator
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _phase_invariant_cfg():
    """min_batch_frames == 1 config (HIEFF, 17 x 869 = 79 whole packets
    per frame) - the valid-continuous-stream sharded mode; mirrors
    tests/test_sharding.py::_phase_invariant_cfg."""
    from dvbt2ll_tpu.config import (CodeRate, Constellation, FFTSize,
                                    FrameSize, GuardInterval, InputMode,
                                    PilotPattern, Rotation, T2Config)
    return T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_2,
        constellation=Constellation.QAM256, rotation=Rotation.ON,
        fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7, fec_blocks=17, ti_blocks=1,
        t2_frames=2, num_data_symbols=12,
        input_mode=InputMode.HIEFF).validate()


def _run_cases(mesh_devices, n_mux=2):
    """The multihost checks: (a) one drift-mode vv009 step (mechanism),
    (b) TWO strict phase-invariant steps (the PRODUCTION valid-stream
    mode, incl. the cross-step carry under DCN).  Returns name -> output
    jax.Array (possibly not fully addressable)."""
    from dvbt2ll_tpu.compile_cache import enable_compile_cache
    from dvbt2ll_tpu.config import vv009_config

    enable_compile_cache()
    from dvbt2ll_tpu.io import synthetic_ts
    from dvbt2ll_tpu.parallel import ShardedTransmitter, make_mesh

    out = {}
    mesh = make_mesh(mesh_devices, mux=n_mux)
    stx = ShardedTransmitter(vv009_config(), mesh, n_mux=n_mux,
                             frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux, seed=TS_SEED + c)
                   for c in range(n_mux)])
    out["vv009_drift"] = stx.step_device(ts)

    stx2 = ShardedTransmitter(_phase_invariant_cfg(), mesh, n_mux=n_mux,
                              frames_per_shard=1)
    n = stx2.bytes_per_step_per_mux
    ts2 = np.stack([synthetic_ts(2 * n, seed=TS_SEED + 10 + c)
                    for c in range(n_mux)])
    out["strict_s1"] = stx2.step_device(ts2[:, :n])
    out["strict_s2"] = stx2.step_device(ts2[:, n:])
    return out


def role_single(out_path):
    import jax

    outs = _run_cases(jax.devices("cpu")[: N_PROCS * DEV_PER_PROC])
    np.savez(out_path, **{k: np.asarray(v) for k, v in outs.items()})
    print(f"single-process: wrote {out_path}", flush=True)


def role_worker(pid, coordinator, out_path):
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=N_PROCS, process_id=pid)
    assert jax.process_count() == N_PROCS
    assert len(jax.devices()) == N_PROCS * DEV_PER_PROC, len(jax.devices())
    outs = _run_cases(jax.devices())

    from jax.experimental import multihost_utils
    gathered = {k: multihost_utils.process_allgather(v, tiled=True)
                for k, v in outs.items()}
    if pid == 0:
        with np.load(out_path) as z:
            for k, got in gathered.items():
                expect = z[k]
                if got.shape != expect.shape:
                    print(f"FAIL {k} shape {got.shape} != {expect.shape}",
                          flush=True)
                    sys.exit(1)
                if not np.array_equal(got, expect):
                    bad = np.abs(got - expect).max()
                    print(f"FAIL {k} multihost output differs, "
                          f"max |d|={bad}", flush=True)
                    sys.exit(1)
        print(f"process 0: 2-host outputs BIT-IDENTICAL to single-process "
              f"({sorted(gathered)}; incl. the strict phase-invariant "
              f"2-step valid-stream mode)", flush=True)
    jax.distributed.shutdown()


def orchestrate():
    import socket

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "single.npz")
        subprocess.run(
            [sys.executable, __file__, "--role", "single", out_path],
            check=True, env=_env(N_PROCS * DEV_PER_PROC), timeout=600)

        procs = [
            subprocess.Popen(
                [sys.executable, __file__, "--role", "worker", str(pid),
                 coordinator, out_path],
                env=_env(DEV_PER_PROC))
            for pid in range(N_PROCS)
        ]
        rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        raise SystemExit(f"multihost dryrun FAILED, rcs={rcs}")
    print(f"multihost dryrun OK: {N_PROCS} processes x {DEV_PER_PROC} "
          "devices, bit-identical to single-process")


if __name__ == "__main__":
    if "--role" not in sys.argv:
        orchestrate()
    elif sys.argv[2] == "single":
        role_single(sys.argv[3])
    else:
        role_worker(int(sys.argv[3]), sys.argv[4], sys.argv[5])
