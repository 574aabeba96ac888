"""Config-derivation tests: counts and invariants from EN 302 755 / SURVEY §2."""
import pytest

from dvbt2ll_tpu.config import (CodeRate, Constellation, FFTSize, FrameSize,
                                GuardInterval, PilotPattern, T2Config,
                                vv009_config)


def test_vv009_derived_constants():
    cfg = vv009_config()
    assert (cfg.kbch, cfg.nbch, cfg.q_ldpc) == (12432, 12600, 10)
    assert cfg.cell_size == 2025
    assert cfg.stream_cells == 16200
    assert (cfg.n_p2, cfg.c_p2) == (4, 2236)
    assert (cfg.c_data, cfg.n_fc, cfg.c_fc) == (3328, 3266, 2792)
    assert cfg.mapped_cells == 18866
    assert cfg.c_ps == 3409
    assert cfg.guard_samples == 128
    assert cfg.samples_per_frame == 31616
    assert (cfg.n_post, cfg.n_punc) == (1512, 8006)
    assert cfg.l1post_cells == 252
    assert cfg.dummy_cells == 100


@pytest.mark.parametrize("frame_size,rate,kbch,nbch,q", [
    (FrameSize.NORMAL, CodeRate.C1_2, 32208, 32400, 90),
    (FrameSize.NORMAL, CodeRate.C5_6, 53840, 54000, 30),
    (FrameSize.SHORT, CodeRate.C1_3, 5232, 5400, 30),
    (FrameSize.SHORT, CodeRate.C3_5, 9552, 9720, 18),
])
def test_fec_params(frame_size, rate, kbch, nbch, q):
    cfg = T2Config(frame_size=frame_size, code_rate=rate,
                   constellation=Constellation.QPSK,
                   pilot_pattern=PilotPattern.PP1, fec_blocks=1, ti_blocks=1)
    assert (cfg.kbch, cfg.nbch, cfg.q_ldpc) == (kbch, nbch, q)
    # nbch - kbch must equal the BCH parity width
    assert cfg.nbch - cfg.kbch == cfg.bch_parity_bits


def test_cell_counts_consistent():
    """nbch*... -> frame_size -> cell_size chain must divide evenly."""
    for fs in FrameSize:
        for c in Constellation:
            cfg = T2Config(frame_size=fs, constellation=c,
                           code_rate=CodeRate.C1_2,
                           pilot_pattern=PilotPattern.PP1, fec_blocks=1,
                           ti_blocks=1)
            assert cfg.ldpc_frame_bits == cfg.cell_size * cfg.mod_bits
            assert cfg.cell_size % 5 == 0  # time-interleaver row constraint


def test_fc_suppression():
    cfg = vv009_config()  # GI 1/32 + PP7: FC present
    assert cfg.has_fc_symbol
    cfg2 = T2Config(guard_interval=GuardInterval.GI_1_32,
                    pilot_pattern=PilotPattern.PP4)
    assert not cfg2.has_fc_symbol  # 1/32+PP4 suppressed in SISO


def test_invalid_combos_raise():
    with pytest.raises(ValueError):
        T2Config(fft_size=FFTSize.FFT_1K,
                 pilot_pattern=PilotPattern.PP7).validate()
    with pytest.raises(ValueError):
        T2Config(frame_size=FrameSize.NORMAL,
                 code_rate=CodeRate.C1_3).validate()
    with pytest.raises(ValueError):
        T2Config(fec_blocks=2000).validate()  # cells exceed frame capacity


def test_version_preamble_gating():
    """The version/preamble constraints the reference encodes in its GRC
    UI (grc/dvbt2ll_framemapperfint_cc.xml:7-29) must be hard errors here;
    each combo below once validated silently."""
    import dataclasses
    from dvbt2ll_tpu.config import Preamble, Version

    base = vv009_config()

    # NON_T2 is the FEF-part S1 label, never a transmitter preamble
    with pytest.raises(ValueError, match="NON_T2"):
        dataclasses.replace(base, preamble=Preamble.NON_T2).validate()

    # T2-Lite preambles exist only in the V1.3.1 option set
    with pytest.raises(ValueError, match="V131"):
        dataclasses.replace(base, preamble=Preamble.T2_LITE_SISO,
                            code_rate=CodeRate.C3_4).validate()

    # lite FFT menu has no 1K/32K
    with pytest.raises(ValueError, match="T2-Lite"):
        dataclasses.replace(
            base, preamble=Preamble.T2_LITE_SISO, version=Version.V131,
            code_rate=CodeRate.C3_4, fft_size=FFTSize.FFT_32K,
            pilot_pattern=PilotPattern.PP7).validate()

    # T2-Lite is short-frames-only, and 4/5 / 5/6 are not lite rates
    with pytest.raises(ValueError, match="short"):
        dataclasses.replace(
            base, preamble=Preamble.T2_LITE_SISO, version=Version.V131,
            frame_size=FrameSize.NORMAL, code_rate=CodeRate.C3_4,
            fec_blocks=2, num_data_symbols=14).validate()
    with pytest.raises(ValueError, match="T2-Lite"):
        dataclasses.replace(base, preamble=Preamble.T2_LITE_SISO,
                            version=Version.V131).validate()  # C4_5

    # 16K-T2GI is the lite-only FFT entry
    with pytest.raises(ValueError, match="16K_T2GI"):
        dataclasses.replace(base, fft_size=FFTSize.FFT_16K_T2GI,
                            pilot_pattern=PilotPattern.PP3,
                            num_data_symbols=4).validate()

    # V1.3.1-only L1 features must not be silently ignored off-version
    with pytest.raises(ValueError, match="l1_scrambled"):
        dataclasses.replace(base, l1_scrambled=True).validate()
    with pytest.raises(ValueError, match="reserved_bias_bits"):
        dataclasses.replace(base, reserved_bias_bits=True).validate()

    # the valid spellings still pass
    dataclasses.replace(base, l1_scrambled=True, reserved_bias_bits=True,
                        version=Version.V131).validate()
    dataclasses.replace(base, preamble=Preamble.T2_LITE_SISO,
                        version=Version.V131,
                        code_rate=CodeRate.C3_4).validate()


def test_frame_duration_example():
    cfg = vv009_config()
    assert abs(cfg.frame_duration - 31616 / (131e6 / 71.0)) < 1e-12


def test_config_json_round_trip():
    """to_json/from_json is lossless - the declarative-config role of the
    reference's GRC XML layer (grc/dvbt2ll_*.xml), one document for the
    whole chain instead of four blocks' duplicated parameters."""
    from dvbt2ll_tpu.config import PLPConfig, T2Config

    cfg = vv009_config()
    assert T2Config.from_json(cfg.to_json()) == cfg

    multi = T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C4_5,
        constellation=Constellation.QAM256,
        fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7, t2_frames=2, num_data_symbols=6,
        plps=(PLPConfig(plp_id=0, plp_type=0, fec_blocks=1, ti_blocks=1),
              PLPConfig(plp_id=1, fec_blocks=2, ti_blocks=1),
              PLPConfig(plp_id=2, fec_blocks=2, ti_blocks=1)),
        fef_length=4096, fef_interval=2).validate()
    back = T2Config.from_json(multi.to_json())
    assert back == multi
    assert back.plps[0].plp_type == 0

    # enums serialize by NAME (human-auditable), and raw ints also load
    d = cfg.to_dict()
    assert d["code_rate"] == "C4_5" and d["fft_size"] == "FFT_4K"
    d["code_rate"] = int(CodeRate.C4_5)
    assert T2Config.from_dict(d) == cfg

    # unknown keys are rejected loudly (the GRC XML layer would silently
    # drop them - a typo must not produce a silently-default chain)
    with pytest.raises(ValueError, match="unknown T2Config fields"):
        T2Config.from_dict({"ffft_size": "FFT_4K"})


def test_validate_fuzz_never_leaks_internal_errors():
    """Any parameter combination either validates or raises a clean
    ValueError - never a KeyError/ZeroDivisionError from the derivation
    chain.  The reference has no cross-block validation at all (the GRC
    XMLs gate options per block; block consistency is the user's job,
    SURVEY section 5.6) - here the single T2Config must be the loud,
    total gatekeeper.  Seeded sweep: ~300 samples, a handful valid."""
    import random

    from dvbt2ll_tpu.config import (Bandwidth, CarrierMode, InBand,
                                    InputMode, L1Constellation, MisoGroup,
                                    PAPR, Preamble, Rotation, Version)

    rng = random.Random(0)
    enums = dict(
        frame_size=list(FrameSize), code_rate=list(CodeRate),
        constellation=list(Constellation), rotation=list(Rotation),
        fft_size=list(FFTSize), guard_interval=list(GuardInterval),
        pilot_pattern=list(PilotPattern), carrier_mode=list(CarrierMode),
        preamble=list(Preamble), miso_group=list(MisoGroup),
        papr=list(PAPR), version=list(Version),
        l1_constellation=list(L1Constellation), input_mode=list(InputMode),
        in_band=list(InBand), bandwidth=list(Bandwidth))
    n_valid = 0
    for _ in range(300):
        kw = {k: rng.choice(v) for k, v in enums.items()}
        kw.update(fec_blocks=rng.choice([0, 1, 2, 8, 200, 3000]),
                  ti_blocks=rng.choice([0, 1, 3, 10]),
                  t2_frames=rng.choice([1, 2, 8, 255, 256]),
                  num_data_symbols=rng.choice([0, 1, 3, 8, 100, 3000]),
                  l1_scrambled=rng.random() < 0.3,
                  reserved_bias_bits=rng.random() < 0.3,
                  fef_length=rng.choice([0, 4096]),
                  fef_interval=rng.choice([1, 2]),
                  sub_slices=rng.choice([1, 2]))
        try:
            cfg = T2Config(**kw).validate()
        except ValueError:
            continue
        # the full derivation chain must also hold for every valid config
        assert cfg.samples_per_frame > 0 and cfg.mapped_cells > 0
        assert cfg.c_data > 0 and cfg.c_ps > 0
        n_valid += 1
    assert n_valid >= 3  # the sweep really does exercise valid configs


def test_enum_typo_raises_value_error():
    """A misspelled enum NAME in a JSON config must raise the loader's
    loud ValueError (with field + choices), not a bare KeyError."""
    d = vv009_config().to_dict()
    d["code_rate"] = "C4_55"
    with pytest.raises(ValueError, match="T2Config.code_rate.*C4_55"):
        T2Config.from_dict(d)


def test_named_config_registry_all_valid():
    """Every name in the bench/golden registry must build a validated
    T2Config (catches registry drift when configs are added)."""
    import pytest

    from tests.test_reference_golden import _named_config
    names = ["vv009_4kshort", "8k_normal", "32k_extended", "hieff_4k",
             "inband_2k", "8k_miso_tx1", "8k_miso_tx2", "32k_papr_tr",
             "16k_l1qpsk_both", "1k_pp4", "qpsk_short_c13", "ti_off_4k",
             "t2lite_4k", "t2lite_8k_t2gi_miso", "v121_4k",
             "t2lite_16k_t2gi", "eq_2k_5mhz", "multiplp_fef"]
    for name in names:
        cfg = _named_config(name)
        cfg.validate()
        assert cfg.samples_per_frame > 2048, name
        # JSON round-trip must reproduce the config exactly (enums by
        # name, nested PLPs included)
        assert type(cfg).from_json(cfg.to_json()) == cfg, name
    with pytest.raises(SystemExit):
        _named_config("no_such_config")
