"""Verification against vectors generated by the REFERENCE C++ itself.

tests/golden_ref/*.npz are produced by tools/gen_reference_golden.py: the
unmodified reference sources (lib/bbheaderbch_bb_impl.cc:648-742 + its
ldpc_calculate :625-646, interleavermod_bc_impl.cc:270-704,
framemapperfint_cc_impl.cc:1948-2151, pilotgenp1insert_cc_impl.cc:2784-2907)
compiled against stub GR headers and driven end-to-end.  These vectors
share ZERO code with dvbt2ll_tpu/, so they verify the table builders the
numpy oracle alone could not.

Checked per config:
  - fast-path FEC stages bit-exact (BB header/scramble/BCH, LDPC)
  - fast-path mapper cells to float32 precision
  - oracle frame-mapper cells >100 dB
  - fast-path AND oracle IQ >100 dB SNR vs the reference waveform

The matrix covers the BASELINE trio plus one config per reference
work-loop branch the trio never takes: HIEFF sync removal
(bbheaderbch_bb_impl.cc:671-688), in-band type B (:327-355,690-693),
MISO TX1/TX2 pilot branches (pilotgenp1insert_cc_impl.cc:668-926),
TR-PAPR reserved tones (:2739-2781), PAPR BOTH + L1-QPSK on the 16K
carrier structure (framemapperfint_cc_impl.cc:1853-1870), the 1K
carrier structure with the (1K, PP4) frame-closing quirk and the 16QAM
L1 bit interleaver (:1832-1852, pilotgenp1insert_cc_impl.cc:1008),
the QPSK low-rate parity-interleave-only mapper branch
(interleavermod_bc_impl.cc:291-314, SHORT C1_3), the ti_blocks=0
time-interleaver bypass (framemapperfint_cc_impl.cc:1108-1119,
:1999-2028), the T2-Lite SISO waveform (S1=3 P1,
pilotgenp1insert_cc_impl.cc:54-56; lite V1.3.1 option set,
grc/dvbt2ll_framemapperfint_cc.xml:7-29), T2-Lite MISO on the
FFT_8K_T2GI size code with a T2GI-menu guard interval (19/128), the
lite-only FFT_16K_T2GI size code (11) with GI 19/256, the V1.2.1
version leg (plp_mode = inputmode + 1,
framemapperfint_cc_impl.cc:214-219), and inverse-sinc pre-equalization
on a non-default bandwidth (pilotgenp1insert_cc_impl.cc:1179-1219,
:2887-2889) — every distinct reference work-loop branch is pinned by
reference-generated vectors.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from dvbt2ll_tpu import refmodel
from dvbt2ll_tpu.io import synthetic_ts
from dvbt2ll_tpu.pipeline import (bb_and_fec, build_frames, map_cells,
                                  modulate)
from dvbt2ll_tpu.plan import build_plan

_DIR = os.path.join(os.path.dirname(__file__), "golden_ref")
_NAMES = ["vv009_4kshort", "8k_normal", "32k_extended",
          "hieff_4k", "inband_2k", "8k_miso_tx1", "8k_miso_tx2",
          "32k_papr_tr", "16k_l1qpsk_both", "1k_pp4",
          "qpsk_short_c13", "ti_off_4k",
          "t2lite_4k", "t2lite_8k_t2gi_miso", "v121_4k",
          "t2lite_16k_t2gi", "eq_2k_5mhz"]


def _named_config(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._named_config(name)


def _load(name):
    path = os.path.join(_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"{path} missing - run tools/gen_reference_golden.py")
    z = np.load(path)
    g = {k: z[k] for k in z.files}

    def bits(stage):
        return np.unpackbits(g[f"{stage}_bits_packed"])[: int(g[f"{stage}_count"])]

    g["stage1_bits"] = bits("stage1")
    g["stage2_bits"] = bits("stage2")
    return g


def _snr_db(ref, x):
    ref = np.asarray(ref, np.complex128).ravel()
    x = np.asarray(x, np.complex128).ravel()
    err = np.sum(np.abs(x - ref) ** 2)
    if err == 0:
        return np.inf
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / err)


@pytest.fixture(scope="module", params=_NAMES)
def case(request):
    name = request.param
    g = _load(name)
    cfg = _named_config(name)
    ts = synthetic_ts(int(g["ts_bytes"]), seed=int(g["ts_seed"]))
    return name, cfg, g, ts


def test_fast_path_fec_bit_exact(case):
    name, cfg, g, ts = case
    nframes = int(g["nframes"])
    plan = build_plan(cfg, nframes, strict=False)
    pp = plan.plps[0]
    padded = jnp.asarray(np.concatenate([np.zeros(187, np.uint8), ts]))
    frame_bits = np.asarray(bb_and_fec(pp, padded))  # (F, frame_bits)
    fecframes = nframes * cfg.fec_blocks
    assert frame_bits.shape == (fecframes, cfg.ldpc_frame_bits)
    ref1 = g["stage1_bits"].reshape(fecframes, cfg.nbch)
    ref2 = g["stage2_bits"].reshape(fecframes, cfg.ldpc_frame_bits)
    np.testing.assert_array_equal(frame_bits[:, : cfg.nbch], ref1)
    np.testing.assert_array_equal(frame_bits, ref2)


def test_fast_path_mapper_cells(case):
    name, cfg, g, ts = case
    nframes = int(g["nframes"])
    fecframes = nframes * cfg.fec_blocks
    ref2 = g["stage2_bits"].reshape(fecframes, cfg.ldpc_frame_bits)
    plan = build_plan(cfg, nframes, strict=False)
    cells = np.asarray(map_cells(plan.plps[0], jnp.asarray(ref2)))
    ref3 = g["stage3_cells"].reshape(fecframes, cfg.cell_size)
    assert _snr_db(ref3, cells) > 100
    np.testing.assert_allclose(cells, ref3, atol=2e-6)


def test_oracle_frame_mapper(case):
    name, cfg, g, ts = case
    nframes = int(g["nframes"])
    ref3 = g["stage3_cells"].reshape(nframes, -1)
    ref4 = g["stage4_frames"].reshape(nframes, cfg.mapped_cells)
    for f in range(nframes):
        mapped = refmodel.frame_map(cfg, ref3[f], f)
        assert _snr_db(ref4[f], mapped) > 100, f"frame {f}"


def test_fast_path_iq_waveform(case):
    name, cfg, g, ts = case
    nframes = int(g["nframes"])
    plan = build_plan(cfg, nframes, strict=False)
    pp = plan.plps[0]
    padded = jnp.asarray(np.concatenate([np.zeros(187, np.uint8), ts]))
    frame_bits = bb_and_fec(pp, padded)
    cells = map_cells(pp, frame_bits)
    payload = cells.reshape(nframes, cfg.stream_cells)
    grids = build_frames(plan, payload, jnp.int32(0))
    iq = np.asarray(modulate(plan, grids))
    ref5 = g["stage5_iq"].reshape(nframes, cfg.samples_per_frame)
    snr = _snr_db(ref5, iq)
    assert snr > 100, f"fast path IQ SNR {snr:.1f} dB vs reference"


def test_oracle_iq_waveform(case):
    name, cfg, g, ts = case
    nframes = int(g["nframes"])
    iq = refmodel.transmit_chain(cfg, ts, nframes).reshape(
        nframes, cfg.samples_per_frame)
    ref5 = g["stage5_iq"].reshape(nframes, cfg.samples_per_frame)
    snr = _snr_db(ref5, iq)
    assert snr > 100, f"oracle IQ SNR {snr:.1f} dB vs reference"
