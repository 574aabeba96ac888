"""The planar-f32 tail: complex64 never materializes.

``transmit_step_iq_planar`` re-expresses the sample domain as separate
re/im f32 planes with the frame builder gathering straight into the
4-step IFFT's transposed layout (ops/ifft4.py).  It must agree with the
complex path to >120 dB at every FFT size.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvbt2ll_tpu.config import (CarrierMode, CodeRate, Constellation,
                                FFTSize, FrameSize, GuardInterval,
                                PilotPattern, Rotation, T2Config,
                                vv009_config)
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.ops.ifft4 import supported
from dvbt2ll_tpu.pipeline import Transmitter, transmit_step_iq_planar


def _cfg_8k():
    return T2Config(
        frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
        constellation=Constellation.QAM64, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
        pilot_pattern=PilotPattern.PP3, fec_blocks=2, ti_blocks=1,
        t2_frames=2, num_data_symbols=8).validate()


def _cfg_32k():
    return T2Config(
        frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
        constellation=Constellation.QAM256, rotation=Rotation.ON,
        fft_size=FFTSize.FFT_32K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7, carrier_mode=CarrierMode.EXTENDED,
        fec_blocks=4, ti_blocks=2, t2_frames=2,
        num_data_symbols=4).validate()


def _named(name):
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._named_config(name)


def _cfg_1k():
    return T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
        constellation=Constellation.QPSK, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_1K, guard_interval=GuardInterval.GI_1_8,
        pilot_pattern=PilotPattern.PP4,
        fec_blocks=1, ti_blocks=1, t2_frames=2,
        num_data_symbols=16).validate()


def _snr_planar_vs_complex(cfg, batch=1, seed=17):
    tx = Transmitter(cfg, batch, strict=False, allow_phase_drift=True)
    assert not tx._planar_tail  # CPU runs the complex tail
    ts = synthetic_ts(tx.bytes_per_step, seed=seed)
    ref = tx(ts)
    w = jnp.asarray(np.concatenate([np.zeros(187, np.uint8), ts]))
    planar = np.asarray(jax.jit(functools.partial(
        transmit_step_iq_planar, tx.plan))(w, jnp.int32(0)))
    got = planar.reshape(planar.shape[0], -1).view(np.complex64)
    err = float((np.abs(got - ref) ** 2).sum())
    return 10 * np.log10(float((np.abs(ref) ** 2).sum())
                         / max(err, 1e-30))


@pytest.mark.parametrize("make_cfg", [
    _cfg_1k,                                   # GI 1/8 = 128, n2 = 8
    lambda: _named("eq_2k_5mhz"),              # 2K + inverse-sinc eq plane
    vv009_config,
    _cfg_8k,
    lambda: _named("16k_l1qpsk_both"),         # 16K extended, GI 1/16
    _cfg_32k,
], ids=["1k", "2k", "4k", "8k", "16k", "32k"])
def test_planar_matches_complex(make_cfg):
    """The planar math holds at every FFT size (16K/32K included) even
    though supported() admits it only up to 8K."""
    cfg = make_cfg()
    snr = _snr_planar_vs_complex(cfg)
    assert snr > 120, f"{snr:.1f} dB"


def test_gate_caps_at_8k():
    assert supported(4096, 128) and supported(8192, 512)
    assert not supported(16384, 512) and not supported(32768, 1024)


def test_planar_multi_frame_and_l1post_rotation():
    """frame_idx0 steering of the per-frame L1-post must survive the
    planar restructure (two steps cross the t2_frames wrap)."""
    cfg = vv009_config()
    tx = Transmitter(cfg, 2, strict=False, allow_phase_drift=True)
    ts = synthetic_ts(tx.bytes_per_step, seed=18)
    ref = tx(ts)
    w = jnp.asarray(np.concatenate([np.zeros(187, np.uint8), ts]))
    fn = jax.jit(functools.partial(transmit_step_iq_planar, tx.plan))
    got = np.asarray(fn(w, jnp.int32(0)))
    got = got.reshape(got.shape[0], -1).view(np.complex64)
    err = float((np.abs(got - ref) ** 2).sum())
    snr = 10 * np.log10(float((np.abs(ref) ** 2).sum()) / max(err, 1e-30))
    assert snr > 120
    # a different frame_idx0 must change the L1-post cells
    got1 = np.asarray(fn(w, jnp.int32(1)))
    assert not np.array_equal(got1, np.asarray(fn(w, jnp.int32(0))))


def test_planar_step_is_shard_invariant():
    """The planar step sharded over a frame mesh must be bit-identical
    to the same planar step run sequentially (the invariant
    ShardedTransmitter relies on wherever select_step_iq picks the planar
    tail)."""
    from jax.sharding import PartitionSpec as P
    from dvbt2ll_tpu.parallel import make_mesh
    from dvbt2ll_tpu.parallel.sharding import _shard_map, halo_windows

    cfg = vv009_config()
    tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True)
    plan = tx.plan
    n = tx.bytes_per_step
    ts = synthetic_ts(4 * n, seed=23)

    # sequential planar: 4 separate steps with the TRUE streaming carry
    # (the 187-byte window tail feeds the next step's first packet CRC,
    # exactly what the sharded halo windows deliver)
    fn = jax.jit(functools.partial(transmit_step_iq_planar, plan))
    seq = []
    carry = np.zeros(187, np.uint8)
    for i in range(4):
        w = jnp.asarray(np.concatenate([carry, ts[i * n:(i + 1) * n]]))
        seq.append(np.asarray(fn(w, jnp.int32(i))))
        carry = ts[(i + 1) * n - 187:(i + 1) * n]
    seq = np.concatenate(seq, axis=0)

    from jax.sharding import NamedSharding
    mesh = make_mesh(jax.devices("cpu")[:4], mux=1)
    wins = halo_windows(ts[None], np.zeros((1, 187), np.uint8), 4)
    fidx = np.arange(4, dtype=np.int32)[None]
    wins_d = jax.device_put(
        wins, NamedSharding(mesh, P("mux", "frame", None)))
    fidx_d = jax.device_put(fidx, NamedSharding(mesh, P("mux", "frame")))

    def shard_fn(w, fi):
        return jax.vmap(lambda ww, f: transmit_step_iq_planar(
            plan, ww[0], f))(w[:, 0][:, None], fi[0])[None]

    sharded_fn = jax.jit(_shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("mux", "frame", None), P("mux", "frame")),
        out_specs=P("mux", "frame", None, None, None), check=False))
    out = np.asarray(sharded_fn(wins_d, fidx_d))[0].reshape(seq.shape)
    assert np.array_equal(out, seq)


def test_unsupported_geometry_keeps_complex_tail(monkeypatch):
    """GIs below 128 samples break the whole-row prefix trick: even where
    a platform's policy is "planar", select_step_iq must gate such
    geometries back to the complex tail, and admit the supported 1K
    geometry (gi = 128, n2 = 8 rows)."""
    from dvbt2ll_tpu import pipeline

    assert not supported(1024, 8)       # GI 1/128 of 1K
    assert not supported(4096 + 1, 128)
    cfg1k = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
        constellation=Constellation.QPSK, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_1K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP1,
        fec_blocks=1, ti_blocks=1, t2_frames=2,
        num_data_symbols=16).validate()
    assert cfg1k.guard_samples == 32
    monkeypatch.setitem(pipeline.STEP_TAIL, "cpu", "planar")
    fn, planar = pipeline.select_step_iq(cfg1k, "cpu")
    assert not planar and fn is pipeline.transmit_step_iq
    cfg1k_ok = _cfg_1k()
    assert supported(cfg1k_ok.fft_points, cfg1k_ok.guard_samples)
    fn, planar = pipeline.select_step_iq(cfg1k_ok, "cpu")
    assert planar and fn is transmit_step_iq_planar
