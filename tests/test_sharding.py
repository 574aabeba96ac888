"""Shard-count invariance: N-device output == sequential single-chain output.

SURVEY.md section 4 item (4): multi-chip tests asserting 1 chip vs N chips
bit-identical, run on the virtual 8-device CPU mesh (conftest.py).
"""
import os

import jax
import numpy as np
import pytest

from dvbt2ll_tpu.config import vv009_config
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.parallel import ShardedTransmitter, make_mesh
from dvbt2ll_tpu.pipeline import Transmitter
from dvbt2ll_tpu.plan import build_plan


def _sequential(cfg, ts, n_steps, batch):
    tx = Transmitter(cfg, batch, strict=False, allow_phase_drift=True)
    outs = [tx(ts[i * tx.bytes_per_step:(i + 1) * tx.bytes_per_step])
            for i in range(n_steps)]
    return np.concatenate(outs, axis=0)  # (n_steps*batch, samples)


def test_frame_sharded_equals_sequential():
    cfg = vv009_config()
    mesh = make_mesh(jax.devices("cpu")[:8], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    ts = synthetic_ts(stx.bytes_per_step_per_mux, seed=21)
    sharded = stx(ts[None, :])[0]            # (8 frames, samples)
    seq = _sequential(cfg, ts, 8, 1)
    assert sharded.shape == seq.shape
    assert np.array_equal(sharded, seq)      # bit-identical, not just close


def test_mux_and_frame_sharded_equals_sequential():
    cfg = vv009_config()
    mesh = make_mesh(jax.devices("cpu")[:8], mux=2)
    stx = ShardedTransmitter(cfg, mesh, n_mux=2, frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    nbytes = stx.bytes_per_step_per_mux
    ts = np.stack([synthetic_ts(nbytes, seed=22), synthetic_ts(nbytes, seed=23)])
    sharded = stx(ts)                        # (2, 4 frames, samples)
    for c in range(2):
        seq = _sequential(cfg, ts[c], 4, 1)
        assert np.array_equal(sharded[c], seq)


def test_sharded_hlo_has_zero_collectives():
    """The steady-state scaling claim rests on this: the compiled 8-device
    sharded step must contain NO inter-device ops, so N chips run N
    disjoint programs and scaling is linear in per-device throughput
    (tools/bench_scaling.py and chip_smoke.py --multi audit the same
    property)."""
    from dvbt2ll_tpu.parallel.sharding import find_collectives, halo_windows

    cfg = vv009_config()
    mesh = make_mesh(jax.devices("cpu")[:8], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1,
                             allow_phase_drift=True, strict=False)
    ts = synthetic_ts(stx.bytes_per_step_per_mux, seed=24)[None]
    w = halo_windows(ts, stx._carries[:, 0], stx.frame_shards)
    fidx = np.zeros((1, stx.frame_shards), np.int32)
    args = [stx._mesh_put(w, stx._in_specs[0]),
            stx._mesh_put(fidx, stx._in_specs[-1])]
    hlo = stx._sharded.lower(*args).compile().as_text()
    assert find_collectives(hlo) == []


def test_find_collectives_matches_async_forms():
    """The audit helper must catch the async -start/-done spellings XLA
    emits, and send/recv — not only the sync forms."""
    from dvbt2ll_tpu.parallel.sharding import find_collectives

    hlo = """
  %ar = f32[8]{0} all-reduce-start(f32[8]{0} %x), replica_groups={}
  %ag = f32[16]{0} all-gather(f32[8]{0} %y), dimensions={0}
  %cp = (f32[4], f32[4]) collective-permute-start(f32[4] %z)
  %sd = (f32[4], u32[], token[]) send(f32[4] %a, token[] %t), channel_id=1
  %rv = (f32[4], u32[], token[]) recv(token[] %t), channel_id=2
  %ok = f32[8]{0} add(f32[8]{0} %x, f32[8]{0} %x)
"""
    hits = find_collectives(hlo)
    assert sorted(hits) == ["all-gather", "all-reduce-start",
                            "collective-permute-start", "recv", "send"]


def test_frame_sharded_streaming_carry():
    """The halo carry must hold across sharded steps too."""
    cfg = vv009_config()
    mesh = make_mesh(jax.devices("cpu")[:4], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(2 * n, seed=24)
    out = np.concatenate([stx(ts[None, :n])[0], stx(ts[None, n:])[0]], axis=0)
    seq = _sequential(cfg, ts, 8, 1)
    assert np.array_equal(out, seq)


def _phase_invariant_cfg():
    """A config whose per-frame TS payload is a whole number of packets
    (HIEFF: 17 x 869 = 79 x 187), so min_batch_frames == 1 and every
    shard/step starts packet-aligned - the valid-continuous-stream mode."""
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


def test_phase_invariant_sharded_valid_stream():
    """The PRODUCTION sharded mode: no allow_phase_drift, strict plans,
    multiple steps - the only configuration that emits a valid continuous
    DVB-T2 mux under sharding (sharding.py constructor happy path).
    Bit-identical to the sequential strict Transmitter across 3 steps.
    Match: the stream-state contract of
    /root/reference/lib/bbheaderbch_bb_impl.cc:701-719."""
    from dvbt2ll_tpu.plan import min_batch_frames

    cfg = _phase_invariant_cfg()
    assert min_batch_frames(cfg) == 1
    mesh = make_mesh(jax.devices("cpu")[:4], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1)
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(3 * n, seed=40)
    sharded = np.concatenate(
        [stx(ts[None, i * n:(i + 1) * n])[0] for i in range(3)], axis=0)

    tx = Transmitter(cfg, 4)  # strict, 4 frames/step == one sharded step
    seq = np.concatenate(
        [tx(ts[i * n:(i + 1) * n]) for i in range(3)], axis=0)
    assert sharded.shape == seq.shape
    assert np.array_equal(sharded, seq)


def test_phase_invariant_sharded_vv009_min_batch():
    """vv009 itself in the valid-stream sharded configuration
    (frames_per_shard = min_batch_frames = 47), 2 shards x 2 steps,
    bit-identical to the sequential strict chain."""
    from dvbt2ll_tpu.plan import min_batch_frames

    cfg = vv009_config()
    b = min_batch_frames(cfg)
    assert b == 47
    mesh = make_mesh(jax.devices("cpu")[:2], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=b)
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(2 * n, seed=41)
    sharded = np.concatenate(
        [stx(ts[None, :n])[0], stx(ts[None, n:])[0]], axis=0)

    tx = Transmitter(cfg, 2 * b)  # strict
    seq = np.concatenate([tx(ts[:n]), tx(ts[n:])], axis=0)
    assert np.array_equal(sharded, seq)


def test_symbol_sharded_modulate_matches():
    from dvbt2ll_tpu.parallel import grids_symbol_sharded
    cfg = vv009_config()
    plan = build_plan(cfg, 1, strict=False)
    mesh = make_mesh(jax.devices("cpu")[:8], mux=1)  # 7 symbols over 8 devs
    fn = grids_symbol_sharded(plan, mesh)
    ts = synthetic_ts(plan.ts_bytes_in, seed=25)
    padded = np.concatenate([np.zeros(187, np.uint8), ts])
    import jax.numpy as jnp
    sharded = np.asarray(fn(jnp.asarray(padded), jnp.int32(0)))
    tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True)
    ref = np.asarray(tx.step_device(ts))
    assert np.array_equal(sharded, ref)


def test_multi_plp_sharded_equals_sequential():
    """Frame-sharding a multi-PLP mux: per-PLP halo windows, bit-identical
    to the sequential multi-PLP chain."""
    from tests.test_multiplp_fef import _mixed_plp_cfg
    cfg = _mixed_plp_cfg()
    mesh = make_mesh(jax.devices("cpu")[:4], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    nb = stx.bytes_per_step_per_mux_per_plp
    ts = [synthetic_ts(nb[0], seed=26)[None], synthetic_ts(nb[1], seed=27)[None]]
    sharded = stx(ts)[0]                       # (4 frames, samples)

    tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True)
    per = tx.bytes_per_step_per_plp
    outs = []
    for i in range(4):
        step = [ts[p][0, i * per[p]:(i + 1) * per[p]] for p in range(2)]
        outs.append(tx(step))
    seq = np.concatenate(outs, axis=0)
    assert np.array_equal(sharded, seq)


def test_sharded_checkpoint_resume():
    """Restoring state_dict must reproduce the exact same output stream."""
    cfg = vv009_config()
    mesh = make_mesh(jax.devices("cpu")[:4], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    n = stx.bytes_per_step_per_mux
    ts = synthetic_ts(3 * n, seed=30)
    stx(ts[None, :n])
    snap = stx.state_dict()
    a = stx(ts[None, n:2 * n])
    b = stx(ts[None, 2 * n:])

    stx2 = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1, allow_phase_drift=True,
                              strict=False)
    stx2.load_state(snap)
    a2 = stx2(ts[None, n:2 * n])
    b2 = stx2(ts[None, 2 * n:])
    assert np.array_equal(a, a2) and np.array_equal(b, b2)

    # the file helpers round-trip the same state (format mirrors
    # Transmitter.save/restore; shaped (mux, plp, 187) carries)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "stx.npz")
        stx2.save(p)
        stx3 = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1,
                                  allow_phase_drift=True, strict=False)
        stx3.restore(p)
        assert stx3._step_no == stx2._step_no
        assert np.array_equal(stx3._carries, stx2._carries)


def test_sharded_fef_stream_matches_sequential():
    """FEF insertion under frame sharding equals the sequential stream()."""
    import dataclasses
    cfg = dataclasses.replace(vv009_config(), fef_length=4096,
                              fef_interval=2).validate()
    mesh = make_mesh(jax.devices("cpu")[:4], mux=1)
    stx = ShardedTransmitter(cfg, mesh, n_mux=1, frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    ts = synthetic_ts(stx.bytes_per_step_per_mux, seed=33)
    sharded = stx.stream(ts[None])[0]

    tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True)
    n = tx.bytes_per_step
    seq = np.concatenate([tx.stream(ts[i * n:(i + 1) * n])
                          for i in range(4)])
    assert np.array_equal(sharded, seq)
