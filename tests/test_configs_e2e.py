"""End-to-end fast-path vs oracle across the BASELINE.json config matrix."""
import numpy as np
import pytest

from dvbt2ll_tpu import refmodel
from dvbt2ll_tpu.config import (CarrierMode, CodeRate, Constellation, FFTSize,
                                FrameSize, GuardInterval, PilotPattern,
                                Rotation, T2Config)
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.pipeline import Transmitter


def _snr_db(cfg, batch=1, seed=31):
    tx = Transmitter(cfg, batch, strict=False)
    ts = synthetic_ts(tx.bytes_per_step, seed=seed)
    out = tx(ts)
    ref = refmodel.transmit_chain(cfg, ts, batch).reshape(batch, -1)
    err = (np.abs(out - ref) ** 2).sum()
    return 10 * np.log10(
        float((np.abs(ref) ** 2).sum()) / max(float(err), 1e-30))


def test_8k_normal_64qam_pp3():
    """BASELINE.json config 2: 8K FFT, normal LDPC frames, 64QAM, PP3, GI 1/16."""
    cfg = T2Config(
        frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
        constellation=Constellation.QAM64, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
        pilot_pattern=PilotPattern.PP3, fec_blocks=2, ti_blocks=1,
        t2_frames=2, num_data_symbols=8).validate()
    assert _snr_db(cfg) > 100.0


def test_32k_extended_256qam_rot_pp7_long_ti():
    """BASELINE.json config 3: 32K extended carriers, 256QAM rotated, PP7,
    multi-block time interleaver (uses the inverted-odd 32K Heven,
    reference lib/framemapperfint_cc_impl.cc:961-977)."""
    cfg = T2Config(
        frame_size=FrameSize.NORMAL, code_rate=CodeRate.C4_5,
        constellation=Constellation.QAM256, rotation=Rotation.ON,
        fft_size=FFTSize.FFT_32K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7, carrier_mode=CarrierMode.EXTENDED,
        fec_blocks=4, ti_blocks=2, t2_frames=2, num_data_symbols=4).validate()
    assert _snr_db(cfg) > 100.0


def test_16k_extended_16qam():
    """Coverage of the remaining large FFT size + 16QAM + extended mode."""
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C3_5,
        constellation=Constellation.QAM16, rotation=Rotation.ON,
        fft_size=FFTSize.FFT_16K, guard_interval=GuardInterval.GI_1_8,
        pilot_pattern=PilotPattern.PP3, carrier_mode=CarrierMode.EXTENDED,
        fec_blocks=3, ti_blocks=1, t2_frames=2, num_data_symbols=6).validate()
    assert _snr_db(cfg) > 100.0


def test_2k_qpsk_small():
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_2,
        constellation=Constellation.QPSK, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
        pilot_pattern=PilotPattern.PP1, fec_blocks=1, ti_blocks=1,
        t2_frames=2, num_data_symbols=16).validate()
    assert _snr_db(cfg) > 100.0


def test_vv009_with_inverse_sinc_equalization():
    from dvbt2ll_tpu.config import vv009_config
    import dataclasses
    cfg = dataclasses.replace(vv009_config(), equalization=True)
    assert _snr_db(cfg) > 100.0
    # the equalized output must actually differ from the unequalized one
    tx_eq = Transmitter(cfg, 1, strict=False)
    tx_no = Transmitter(dataclasses.replace(cfg, equalization=False), 1,
                        strict=False)
    ts = synthetic_ts(tx_eq.bytes_per_step, seed=41)
    assert not np.allclose(tx_eq(ts), tx_no(ts))


@pytest.mark.parametrize("group", [0, 1])
def test_miso_pilot_inversions(group):
    """MISO TX1/TX2: P2/SP/CP pilot handling incl. TX2 inversions
    (reference pilotgenp1insert :668-926 MISO branches)."""
    from dvbt2ll_tpu.config import (L1Constellation, MisoGroup, Preamble)
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_2,
        constellation=Constellation.QPSK, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
        pilot_pattern=PilotPattern.PP1, fec_blocks=1, ti_blocks=1,
        t2_frames=2, num_data_symbols=8, preamble=Preamble.T2_MISO,
        miso_group=MisoGroup(group),
        l1_constellation=L1Constellation.BPSK).validate()
    assert _snr_db(cfg, seed=91) > 100.0


def test_miso_groups_differ():
    from dvbt2ll_tpu.config import (L1Constellation, MisoGroup, Preamble)
    import dataclasses
    from dvbt2ll_tpu.io import synthetic_ts
    base = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_2,
        constellation=Constellation.QPSK, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
        pilot_pattern=PilotPattern.PP1, fec_blocks=1, ti_blocks=1,
        t2_frames=2, num_data_symbols=8, preamble=Preamble.T2_MISO,
        l1_constellation=L1Constellation.BPSK).validate()
    tx1 = Transmitter(base, 1, strict=False)
    tx2 = Transmitter(dataclasses.replace(
        base, miso_group=MisoGroup.TX2), 1, strict=False)
    ts = synthetic_ts(tx1.bytes_per_step, seed=92)
    assert not np.allclose(tx1(ts), tx2(ts))


@pytest.mark.parametrize("fft,pp,gi,group,ndata", [
    (FFTSize.FFT_8K, PilotPattern.PP3, GuardInterval.GI_1_16, 0, 8),
    (FFTSize.FFT_16K, PilotPattern.PP3, GuardInterval.GI_1_16, 1, 6),
    (FFTSize.FFT_32K, PilotPattern.PP7, GuardInterval.GI_1_32, 0, 4),
    (FFTSize.FFT_32K, PilotPattern.PP7, GuardInterval.GI_1_32, 1, 4),
])
def test_miso_large_fft_extended(fft, pp, gi, group, ndata):
    """MISO TX1/TX2 at 8K/16K/32K with EXTENDED carriers: the FFT-size-
    specific P2-pilot branches (32K MISO keeps the every-3rd-carrier grid
    instead of SISO's every-6th), the 4 extra edge P2 pilots, K_EXT edge
    extension, and TX2 pilot inversions (reference
    lib/pilotgenp1insert_cc_impl.cc:668-926)."""
    from dvbt2ll_tpu.config import MisoGroup, Preamble
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
        constellation=Constellation.QAM64, rotation=Rotation.OFF,
        fft_size=fft, guard_interval=gi, pilot_pattern=pp,
        carrier_mode=CarrierMode.EXTENDED, preamble=Preamble.T2_MISO,
        miso_group=MisoGroup(group), fec_blocks=2, ti_blocks=1,
        t2_frames=2, num_data_symbols=ndata).validate()
    assert _snr_db(cfg, seed=120 + 2 * int(fft) + group) > 100.0


def test_miso_papr_adjacent_extra_pilots():
    """MISO + TR-PAPR: P2-PAPR holes that land next to the every-3rd-
    carrier P2 pilot grid grow flanking extra P2 pilots (reference
    lib/pilotgenp1insert_cc_impl.cc:736-792 MISO k%3 branches)."""
    from dvbt2ll_tpu.config import MisoGroup, PAPR, Preamble
    from dvbt2ll_tpu.tables.pilots import _INVERT_BIT, _p2_carrier_map, P2PILOT
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
        constellation=Constellation.QAM64, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
        pilot_pattern=PilotPattern.PP3, carrier_mode=CarrierMode.EXTENDED,
        preamble=Preamble.T2_MISO, miso_group=MisoGroup.TX1, papr=PAPR.TR,
        fec_blocks=2, ti_blocks=1, t2_frames=2,
        num_data_symbols=8).validate()
    # the extra-pilot rule must actually fire for this config: some
    # carrier is a P2 pilot here that is NOT one in the SISO map
    import dataclasses
    siso = dataclasses.replace(cfg, preamble=Preamble.T2_SISO).validate()
    m_miso = _p2_carrier_map(cfg) & ~np.int32(_INVERT_BIT)
    m_siso = _p2_carrier_map(siso)
    extra = ((m_miso == P2PILOT) & (m_siso != P2PILOT)).sum()
    assert extra > 0
    assert _snr_db(cfg, seed=130) > 100.0


def test_papr_both_reserved_tones():
    """PAPR.BOTH = TR tone reservation + ACE signalling: same carrier
    budget as TR, different L1 papr field (reference dvbt2ll_config.h
    PAPR_BOTH; pilotgenp1insert treats TR and BOTH identically)."""
    import dataclasses
    from dvbt2ll_tpu.config import PAPR, vv009_config
    cfg = dataclasses.replace(vv009_config(), papr=PAPR.BOTH,
                              num_data_symbols=4).validate()
    tr = dataclasses.replace(vv009_config(), papr=PAPR.TR,
                             num_data_symbols=4).validate()
    assert cfg.c_data == tr.c_data          # same tone reservation as TR
    assert _snr_db(cfg, seed=131) > 100.0
    # the L1 papr field distinguishes BOTH from TR
    tx_both = Transmitter(cfg, 1, strict=False)
    tx_tr = Transmitter(tr, 1, strict=False)
    ts = synthetic_ts(tx_both.bytes_per_step, seed=131)
    assert not np.allclose(tx_both(ts), tx_tr(ts))


def test_papr_tr_extended_carriers():
    """TR-PAPR with EXTENDED carriers: the reserved-tone map shifts by
    K_EXT on 8K+ (reference pilotgenp1insert_cc_impl.cc:2739-2781 papr_map
    offsets), and the per-symbol TR shift wraps within C_PS."""
    from dvbt2ll_tpu.config import PAPR
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
        constellation=Constellation.QAM64, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
        pilot_pattern=PilotPattern.PP3, carrier_mode=CarrierMode.EXTENDED,
        papr=PAPR.TR, fec_blocks=2, ti_blocks=1, t2_frames=2,
        num_data_symbols=8).validate()
    assert _snr_db(cfg, seed=132) > 100.0


def test_1k_fft_small():
    """1K FFT coverage (smallest carrier structure, C_PS=853)."""
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_2,
        constellation=Constellation.QPSK, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_1K, guard_interval=GuardInterval.GI_1_8,
        pilot_pattern=PilotPattern.PP1, fec_blocks=1, ti_blocks=1,
        t2_frames=2, num_data_symbols=24).validate()
    assert _snr_db(cfg, seed=51) > 100.0


def test_papr_tr_reserved_tones():
    """TR-PAPR reserved tones: P2-PAPR holes in P2 symbols and shifted TR
    tones in data symbols (reference pilotgenp1insert :2739-2781), with
    the C_DATA/N_FC/C_FC reductions of the PAPR tables."""
    import dataclasses
    from dvbt2ll_tpu.config import PAPR, vv009_config
    cfg = dataclasses.replace(vv009_config(), papr=PAPR.TR,
                              num_data_symbols=4).validate()
    assert _snr_db(cfg, seed=52) > 100.0
    # reserved tones change the carrier budget and therefore the waveform
    base = vv009_config()
    assert cfg.c_data < base.c_data


@pytest.mark.parametrize("l1c", [1, 2, 3])
def test_l1_constellations(l1c):
    """L1-post mapped as QPSK/16QAM/64QAM incl. the L1 bit interleaver
    (reference framemapperfint :1832-1909)."""
    from dvbt2ll_tpu.config import L1Constellation
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_2,
        constellation=Constellation.QPSK, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_2K, guard_interval=GuardInterval.GI_1_8,
        pilot_pattern=PilotPattern.PP1, fec_blocks=1, ti_blocks=1,
        t2_frames=2, num_data_symbols=12,
        l1_constellation=L1Constellation(l1c)).validate()
    assert _snr_db(cfg, seed=53 + l1c) > 100.0


def test_v131_l1post_scrambling():
    """V1.3.1 L1-post scrambling (reference framemapperfint :1693-1697,
    init_l1_randomizer :1928-1940) changes the L1 cells but stays
    oracle-exact."""
    import dataclasses
    from dvbt2ll_tpu.config import Version, vv009_config
    base = vv009_config()
    cfg = dataclasses.replace(base, version=Version.V131,
                              l1_scrambled=True).validate()
    assert _snr_db(cfg, seed=57) > 100.0
    tx_a = Transmitter(cfg, 1, strict=False)
    tx_b = Transmitter(base, 1, strict=False)
    ts = synthetic_ts(tx_a.bytes_per_step, seed=57)
    assert not np.allclose(tx_a(ts), tx_b(ts))


@pytest.mark.parametrize("fft,gi,pp", [
    (FFTSize.FFT_8K_T2GI, GuardInterval.GI_19_128, PilotPattern.PP8),
    (FFTSize.FFT_32K_T2GI, GuardInterval.GI_19_256, PilotPattern.PP8),
    (FFTSize.FFT_32K_T2GI, GuardInterval.GI_1_128, PilotPattern.PP7),
])
def test_t2gi_long_guard_intervals(fft, gi, pp):
    """The T2-only guard intervals (1/128, 19/128, 19/256) on the _T2GI FFT
    size codes, incl. PP8 (no frame-closing symbol in these combos:
    reference framemapperfint :898-915)."""
    cfg = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C2_3,
        constellation=Constellation.QAM64, rotation=Rotation.OFF,
        fft_size=fft, guard_interval=gi, pilot_pattern=pp,
        fec_blocks=2, ti_blocks=1, t2_frames=2,
        num_data_symbols=4).validate()
    assert _snr_db(cfg, seed=61 + int(fft)) > 100.0


def test_ti_off_bypass():
    """ti_blocks=0: the time-interleaver bypass (reference
    framemapperfint :1108-1119 partition, :1999-2028 passthrough copy).
    The cell interleaver still runs, with the SAME first bit-reversed
    shift for every FEC frame (n restarts per one-frame 'TI block').
    Untested parity code is unverified parity — this pins
    the oracle e2e path; tests/golden_ref/ti_off_4k.npz pins the same
    branch against the reference binary."""
    import dataclasses
    from dvbt2ll_tpu.config import vv009_config
    cfg = dataclasses.replace(vv009_config(), ti_blocks=0).validate()
    assert _snr_db(cfg, batch=2, seed=91) > 100.0
    # TI-off must actually change the waveform vs the vv009 3-block TI
    tx_off = Transmitter(cfg, 1, strict=False)
    tx_on = Transmitter(vv009_config(), 1, strict=False)
    ts = synthetic_ts(tx_off.bytes_per_step, seed=91)
    assert not np.allclose(tx_off(ts), tx_on(ts))


def test_ti_off_normal_frames():
    """ti_blocks=0 on NORMAL LDPC frames (different cell_size/LFSR degree
    for the per-frame cell-interleaver shift)."""
    cfg = T2Config(
        frame_size=FrameSize.NORMAL, code_rate=CodeRate.C2_3,
        constellation=Constellation.QAM64, rotation=Rotation.OFF,
        fft_size=FFTSize.FFT_8K, guard_interval=GuardInterval.GI_1_16,
        pilot_pattern=PilotPattern.PP3, fec_blocks=2, ti_blocks=0,
        t2_frames=2, num_data_symbols=8).validate()
    assert _snr_db(cfg, seed=92) > 100.0


@pytest.mark.parametrize("pre", [3, 4])
def test_t2_lite_preambles(pre):
    """T2-Lite SISO/MISO: P1 S1 field and pattern change with the preamble
    (reference pilotgenp1insert :54-56, s1 = preamble), L1-pre TYPE follows."""
    import dataclasses
    from dvbt2ll_tpu.config import (CodeRate, MisoGroup, Preamble, Version,
                                    vv009_config)
    base = vv009_config()
    cfg = dataclasses.replace(
        base, preamble=Preamble(pre), miso_group=MisoGroup.TX1,
        # T2-Lite gating (config.validate): V1.3.1 only, and C4_5 is not a
        # lite rate — C3_4 keeps the identical cell budget
        version=Version.V131, code_rate=CodeRate.C3_4,
        # MISO halves the P2 cell budget; add a data symbol to fit
        num_data_symbols=4 if pre == 4 else base.num_data_symbols).validate()
    assert _snr_db(cfg, seed=71 + pre) > 100.0
    # the P1 of a T2-Lite frame must differ from the plain T2 one
    # (C3_4 consumes fewer TS bytes per step than the base C4_5, so each
    # transmitter gets its own correctly-sized stream; P1 is data-free)
    tx_lite = Transmitter(cfg, 1, strict=False)
    tx_t2 = Transmitter(base, 1, strict=False)
    a = tx_lite(synthetic_ts(tx_lite.bytes_per_step, seed=71))
    b = tx_t2(synthetic_ts(tx_t2.bytes_per_step, seed=71))
    assert not np.allclose(a[:, :2048], b[:, :2048])


def test_reserved_bias_bits_v131():
    """V1.3.1 L1 bias balancing: reserved fields forced to all-ones
    (reference framemapperfint :145-250 RESERVED_ON branches)."""
    import dataclasses
    from dvbt2ll_tpu.config import Version, vv009_config
    base = dataclasses.replace(vv009_config(), version=Version.V131)
    cfg = dataclasses.replace(base, reserved_bias_bits=True).validate()
    assert _snr_db(cfg, seed=81) > 100.0
    tx_a = Transmitter(cfg, 1, strict=False)
    tx_b = Transmitter(base, 1, strict=False)
    ts = synthetic_ts(tx_a.bytes_per_step, seed=81)
    assert not np.allclose(tx_a(ts), tx_b(ts))


def test_papr_ace_signalling_only():
    """ACE PAPR is signalling-only in the reference (no tone reservation:
    the carrier budget is unchanged, only the L1 papr field differs)."""
    import dataclasses
    from dvbt2ll_tpu.config import PAPR, vv009_config
    base = vv009_config()
    cfg = dataclasses.replace(base, papr=PAPR.ACE).validate()
    assert cfg.c_data == base.c_data          # no reserved tones
    assert _snr_db(cfg, seed=82) > 100.0
    tx_a = Transmitter(cfg, 1, strict=False)
    tx_b = Transmitter(base, 1, strict=False)
    ts = synthetic_ts(tx_a.bytes_per_step, seed=82)
    assert not np.allclose(tx_a(ts), tx_b(ts))  # L1 papr field differs


def test_non_t2_preamble_is_fef_only():
    """S1=NON_T2 labels FEF parts, not T2 frames: validate() rejects it as
    a transmitter preamble (round-4 gating), and the FEF-part P1 the
    chain DOES emit with S1=NON_T2 (tables/pilots.py fef_part) differs
    from the T2 frame's P1."""
    import dataclasses
    from dvbt2ll_tpu.config import Preamble, vv009_config
    base = vv009_config()
    with pytest.raises(ValueError, match="NON_T2"):
        dataclasses.replace(base, preamble=Preamble.NON_T2).validate()
    cfg = dataclasses.replace(base, fef_length=4096, fef_interval=2,
                              ).validate()
    tx = Transmitter(cfg, 1, strict=False)
    fef_p1 = tx.plan.fef_part[:2048]
    ts = synthetic_ts(tx.bytes_per_step, seed=83)
    frame_p1 = tx(ts)[0, :2048]
    assert not np.allclose(fef_p1, frame_p1)


@pytest.mark.parametrize("bw", [0, 3, 5])
def test_inverse_sinc_per_bandwidth(bw):
    """Inverse-sinc pre-equalization differs per bandwidth profile
    (reference pilotgenp1insert :1179-1219 sample-rate table)."""
    import dataclasses
    from dvbt2ll_tpu.config import Bandwidth, vv009_config
    cfg = dataclasses.replace(vv009_config(), equalization=True,
                              bandwidth=Bandwidth(bw)).validate()
    assert _snr_db(cfg, seed=84 + bw) > 100.0


def test_inverse_sinc_bandwidth_invariance():
    """The reference steps f by fs/vlength and evaluates sinc(pi*f/fs), so
    fs cancels: the pre-equalization table is IDENTICAL for every
    bandwidth profile (pilotgenp1insert :1202-1215).  Pin that quirk."""
    import dataclasses
    from dvbt2ll_tpu.config import Bandwidth, vv009_config
    from dvbt2ll_tpu.tables.pilots import inverse_sinc
    eqs = [inverse_sinc(dataclasses.replace(
        vv009_config(), equalization=True, bandwidth=Bandwidth(b)))
        for b in range(6)]
    for i in range(1, 6):
        assert np.array_equal(eqs[0], eqs[i])
