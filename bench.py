"""Benchmark: sustained baseband throughput of the vv009-4kshort chain.

Prints ONE JSON line.  ``vs_baseline`` is the real-time factor against the
reference example app's output sample rate of (8e6*8)/7 ~= 9.142857 Msamp/s
(apps/vv009-4kshort.grc `samp_rate`; BASELINE.md) — the rate the reference
C++ chain must sustain on a desktop CPU.

Input TS windows are pre-staged on the device and rotated, modeling a
pipelined ingest (the 12.5 KB/frame TS input is 4 Mbit/s per mux in real
time); the served path from TS ingest to the sink is chip_smoke.py's
phase 2 and tools/bench_sustained.py.  Needs a GPU: any other default
device exits non-zero.

Usage: python bench.py [batch] [steps] [config]
"""
import json
import sys
import time


def _named_config(name):
    """Named config registry: the BASELINE.json matrix (first three) plus
    the reference-golden mode/MISO matrix (tools/gen_reference_golden.py,
    tests/test_reference_golden.py)."""
    from dvbt2ll_tpu.config import (CarrierMode, CodeRate, Constellation,
                                    FFTSize, FrameSize, GuardInterval,
                                    InBand, InputMode, L1Constellation,
                                    MisoGroup, PAPR, PilotPattern, Preamble,
                                    Rotation, T2Config, vv009_config)
    if name == "vv009_4kshort":
        return vv009_config()
    if name == "8k_normal":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM64, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
            pilot_pattern=PilotPattern.PP3, fec_blocks=2, ti_blocks=1,
            t2_frames=2, num_data_symbols=8).validate()
    if name == "32k_extended":
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_32K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, carrier_mode=CarrierMode.EXTENDED,
            fec_blocks=4, ti_blocks=2, t2_frames=2,
            num_data_symbols=4).validate()
    # --- reference-golden mode/MISO matrix (each pins a reference work-
    # loop branch the BASELINE trio never takes) ---------------------------
    # NOTE: the reference's ldpc_lookup_generate (lib/bbheaderbch_bb_impl.cc
    # :569-623) heap-overflows for SHORT C1_2/C3_4/C5_6 (verified with ASan;
    # its example app never constructs those), so the golden matrix sticks
    # to ctor-safe rates.  This framework itself covers all 14 configs
    # against the numpy oracle (tests/test_fec.py).
    if name == "hieff_4k":
        # HIEFF sync removal, lib/bbheaderbch_bb_impl.cc:671-688; NORMAL
        # C4_5 because 17 x 6446 payload bytes = whole 187-byte packets
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, fec_blocks=1, ti_blocks=1,
            t2_frames=2, num_data_symbols=3,
            input_mode=InputMode.HIEFF).validate()
    if name == "inband_2k":
        # in-band type B, lib/bbheaderbch_bb_impl.cc:327-355,690-693
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP1, fec_blocks=2, ti_blocks=1,
            t2_frames=2, num_data_symbols=8,
            l1_constellation=L1Constellation.BPSK,
            in_band=InBand.ON, ts_rate=4_000_000).validate()
    if name in ("8k_miso_tx1", "8k_miso_tx2"):
        # MISO pilot branches, lib/pilotgenp1insert_cc_impl.cc:668-926
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM64, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
            pilot_pattern=PilotPattern.PP3, carrier_mode=CarrierMode.EXTENDED,
            preamble=Preamble.T2_MISO,
            miso_group=(MisoGroup.TX1 if name.endswith("tx1")
                        else MisoGroup.TX2),
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=8).validate()
    if name == "16k_l1qpsk_both":
        # 16K carrier structure (no golden pinned it before), L1-post as
        # QPSK (framemapperfint_cc_impl.cc:1853-1870) and PAPR BOTH,
        # which the reference's pilot generator treats exactly like TR
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM16, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_16K, guard_interval=GuardInterval.GI_1_16,
            pilot_pattern=PilotPattern.PP3, carrier_mode=CarrierMode.EXTENDED,
            papr=PAPR.BOTH, l1_constellation=L1Constellation.QPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=6).validate()
    if name == "1k_pp4":
        # 1K carrier structure (C_PS=853), the (1K, PP4) frame-closing
        # extra-scattered-pilot quirk (pilotgenp1insert_cc_impl.cc:1008),
        # and the 16QAM L1 bit interleaver (framemapperfint :1832-1852)
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_1K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP4,
            l1_constellation=L1Constellation.QAM16,
            fec_blocks=1, ti_blocks=1, t2_frames=2,
            num_data_symbols=16).validate()
    if name == "qpsk_short_c13":
        # the parity-interleave-only work loop: QPSK at rates 1/3 and 2/5
        # takes the dedicated branch with parity interleaving but NO
        # column twist (lib/interleavermod_bc_impl.cc:291-314) — the last
        # distinct mapper branch without a reference-generated vector
        # (SHORT C1_3 is ctor-safe in the reference, unlike C1_2/C3_4/C5_6)
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_3,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP1,
            l1_constellation=L1Constellation.BPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=8).validate()
    if name == "ti_off_4k":
        # time-interleaver bypass: ti_blocks=0 keeps the cell interleaver
        # (same first bit-reversed shift for every FEC frame) but skips
        # the row/column transpose (lib/framemapperfint_cc_impl.cc:
        # 1108-1119 partition, :1999-2028 bypass copy)
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, fec_blocks=8, ti_blocks=0,
            t2_frames=2, num_data_symbols=3).validate()
    if name == "t2lite_4k":
        # T2-Lite SISO waveform: S1 = 3 in the P1 preamble
        # (lib/pilotgenp1insert_cc_impl.cc:54-56), lite option set of the
        # V1.3.1 UI (grc/dvbt2ll_framemapperfint_cc.xml:7-29); profile
        # rules per EN 302 755 V1.3.1 Annex I (short frames, rate <= 2/3)
        from dvbt2ll_tpu.config import Version
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM16, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, preamble=Preamble.T2_LITE_SISO,
            version=Version.V131, l1_constellation=L1Constellation.QPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2,
            num_data_symbols=3).validate()
    if name == "t2lite_8k_t2gi_miso":
        # T2-Lite MISO (S1 = 4) on the FFT_8K_T2GI size code with a
        # T2GI-menu guard interval (19/128) - pins the lite MISO pilot
        # inversions AND the T2GI FFT-size leg in one config
        # (lib/pilotgenp1insert_cc_impl.cc:72,104,137 FFTSIZE_8K_T2GI)
        from dvbt2ll_tpu.config import Version
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C3_5,
            constellation=Constellation.QPSK, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_8K_T2GI,
            guard_interval=GuardInterval.GI_19_128,
            pilot_pattern=PilotPattern.PP3, preamble=Preamble.T2_LITE_MISO,
            miso_group=MisoGroup.TX2, version=Version.V131,
            l1_constellation=L1Constellation.BPSK,
            fec_blocks=1, ti_blocks=1, t2_frames=2,
            num_data_symbols=4).validate()
    if name == "t2lite_16k_t2gi":
        # FFT_16K_T2GI (size code 11) - the lite-ONLY member of the FFT
        # menu (base profile has plain FFT_16K); with GI 19/256 from the
        # T2GI guard menu.  s2 = 11 & 0x7 = 3 rides through L1/P1 exactly
        # as the reference computes it (framemapperfint_cc_impl.cc:118,
        # pilotgenp1insert_cc_impl.cc:1120)
        from dvbt2ll_tpu.config import Version
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_5,
            constellation=Constellation.QAM16, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_16K_T2GI,
            guard_interval=GuardInterval.GI_19_256,
            pilot_pattern=PilotPattern.PP3, preamble=Preamble.T2_LITE_SISO,
            version=Version.V131, l1_constellation=L1Constellation.QPSK,
            fec_blocks=6, ti_blocks=2, t2_frames=2,
            num_data_symbols=3).validate()
    if name == "v121_4k":
        # the V1.2.1 version leg: plp_mode = inputmode + 1 in L1-post
        # (lib/framemapperfint_cc_impl.cc:214-219) with the V1.3.1-only
        # fields (l1_post_scrambled, reserved bias, fef_length_msb) off
        from dvbt2ll_tpu.config import Version
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, version=Version.V121,
            fec_blocks=3, ti_blocks=1, t2_frames=2,
            num_data_symbols=3).validate()
    if name == "multiplp_fef":
        # BASELINE config 4: two type-1 data PLPs with mixed code rates /
        # constellations plus FEF insertion - capability beyond the
        # reference (num_plp=1 hardcoded, framemapperfint_cc_impl.cc:153)
        from dvbt2ll_tpu.config import PLPConfig
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7,
            plps=(
                PLPConfig(plp_id=0, code_rate=CodeRate.C4_5,
                          constellation=Constellation.QAM256,
                          rotation=Rotation.ON, frame_size=FrameSize.SHORT,
                          fec_blocks=4, ti_blocks=2),
                PLPConfig(plp_id=1, code_rate=CodeRate.C1_2,
                          constellation=Constellation.QAM16,
                          rotation=Rotation.OFF, frame_size=FrameSize.SHORT,
                          fec_blocks=2, ti_blocks=1),
            ),
            fec_blocks=4, ti_blocks=2, t2_frames=2, num_data_symbols=3,
            fef_length=4096, fef_interval=2).validate()
    if name == "eq_2k_5mhz":
        # inverse-sinc pre-equalization ON (the VOLK-multiply branch,
        # lib/pilotgenp1insert_cc_impl.cc:1179-1219, :2887-2889) on a
        # non-default bandwidth (5 MHz) - pins the eq plane incl. the
        # sincrms normalization against the reference binary; the sinc
        # shape itself is bandwidth-independent (x = pi*i/vlength)
        from dvbt2ll_tpu.config import Bandwidth
        return T2Config(
            frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
            constellation=Constellation.QAM16, rotation=Rotation.OFF,
            fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
            pilot_pattern=PilotPattern.PP1,
            l1_constellation=L1Constellation.BPSK,
            fec_blocks=2, ti_blocks=1, t2_frames=2, num_data_symbols=8,
            equalization=True, bandwidth=Bandwidth.BW_5_0_MHZ).validate()
    if name == "32k_papr_tr":
        # TR-PAPR reserved tones, lib/pilotgenp1insert_cc_impl.cc:2739-2781
        return T2Config(
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
            constellation=Constellation.QAM256, rotation=Rotation.ON,
            fft_size=FFTSize.FFT_32K, guard_interval=GuardInterval.GI_1_32,
            pilot_pattern=PilotPattern.PP7, carrier_mode=CarrierMode.EXTENDED,
            papr=PAPR.TR, fec_blocks=4, ti_blocks=2, t2_frames=2,
            num_data_symbols=4).validate()
    raise SystemExit(f"unknown config {name!r}")


def main():
    import jax

    from dvbt2ll_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; the default device is "
                         f"{dev.platform} ({dev.device_kind})")
    import jax.numpy as jnp
    import numpy as np

    from dvbt2ll_tpu.io import synthetic_ts
    from dvbt2ll_tpu.pipeline import Transmitter

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    name = sys.argv[3] if len(sys.argv) > 3 else "vv009_4kshort"

    cfg = _named_config(name)
    baseline_samp_rate = 8e6 * 8 / 7  # the grc app's samp_rate variable
    tx = Transmitter(cfg, batch, strict=False)

    # pre-staged rotating inputs (distinct, with the 187-byte carry
    # window); multi-PLP configs stage one stream per PLP
    per_plp = tx.bytes_per_step_per_plp
    carries = [np.zeros(187, np.uint8) for _ in per_plp]
    dev_in = []
    for s in range(4):
        step_in = []
        for i, n_p in enumerate(per_plp):
            ts = synthetic_ts(n_p, seed=16 * s + i)
            padded = np.concatenate([carries[i], ts])
            carries[i] = padded[-187:]
            step_in.append(jnp.asarray(padded))
        dev_in.append(step_in if len(step_in) > 1 else step_in[0])

    step = tx._step
    fi = jnp.int32(0)
    jax.block_until_ready(step(dev_in[0], fi))  # compile

    t0 = time.perf_counter()
    out = None
    for i in range(steps):
        out = step(dev_in[i % 4], fi)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    assert np.isfinite(np.asarray(out[0, :64])).all()

    rate = steps * batch * cfg.samples_per_frame / dt
    print(json.dumps({
        "metric": f"{name}_throughput",
        "value": rate / 1e6,
        "unit": "Msamples/s/device",
        "vs_baseline": rate / baseline_samp_rate,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
