"""BCH / LDPC / CRC construction tests (golden properties + oracle cross-checks)."""
import numpy as np
import pytest

from dvbt2ll_tpu.config import CodeRate, FrameSize, T2Config, vv009_config
from dvbt2ll_tpu.tables import bch, ldpc
from dvbt2ll_tpu.tables.bbframe import (_crc8_byte_table, header_crc8_bits,
                                        packet_crc_matrix)


def test_bch_generator_degrees():
    # degree == parity width for every code (EN 302 755 table 6)
    assert bch.generator_poly(True, 12).bit_length() - 1 == 168
    assert bch.generator_poly(False, 12).bit_length() - 1 == 192
    assert bch.generator_poly(False, 10).bit_length() - 1 == 160
    assert bch.generator_poly(False, 8).bit_length() - 1 == 128


@pytest.mark.parametrize("short,t,k", [(True, 12, 400), (False, 10, 333),
                                       (False, 12, 512)])
def test_bch_matrix_matches_serial(short, t, k):
    rng = np.random.default_rng(1)
    G = bch.parity_matrix(k, short, t)
    for _ in range(3):
        m = rng.integers(0, 2, k).astype(np.uint8)
        assert ((m @ G.astype(np.int64)) & 1 == bch.encode_ref(m, short, t)).all()


def test_bch_codeword_divisible_by_generator():
    """Systematic codeword polynomial must be divisible by g(x)."""
    short, t, k = True, 12, 200
    g = bch.generator_poly(short, t)
    npar = 168
    rng = np.random.default_rng(2)
    m = rng.integers(0, 2, k).astype(np.uint8)
    parity = (m @ bch.parity_matrix(k, short, t).astype(np.int64)) & 1
    # codeword value: bits MSB-first == polynomial with first bit highest power
    val = 0
    for b in np.concatenate([m, parity]):
        val = (val << 1) | int(b)
    # long-division remainder must be zero
    while val.bit_length() > npar:
        val ^= g << (val.bit_length() - 1 - npar)
    assert val == 0


@pytest.mark.parametrize("frame_size,rate", [
    (FrameSize.SHORT, CodeRate.C4_5),
    (FrameSize.SHORT, CodeRate.C1_3),
    (FrameSize.NORMAL, CodeRate.C1_2),
    (FrameSize.NORMAL, CodeRate.C5_6),
])
def test_ldpc_gather_matches_scatter(frame_size, rate):
    tab = {FrameSize.SHORT: 16200, FrameSize.NORMAL: 64800}[frame_size]
    cfg = T2Config(frame_size=frame_size, code_rate=rate, fec_blocks=1,
                   ti_blocks=1)
    npar, k, q = tab - cfg.nbch, cfg.nbch, cfg.q_ldpc
    gather, counts = ldpc.encoder_gather(frame_size, rate, npar, k, q)
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, k).astype(np.uint8)
    ext = np.concatenate([info, [0]]).astype(np.int64)
    p_gather = np.bitwise_and(np.cumsum(ext[gather].sum(1) & 1), 1)
    p_scatter = ldpc.encode_ref(info, frame_size, rate, npar, q)
    assert (p_gather == p_scatter).all()


def test_ldpc_parity_check_property():
    """H·c == 0: re-derive the checks from the accumulator definition.

    Parity bit chain p[j] = a[j] ^ p[j-1] means check j is
    a[j] ^ p[j] ^ p[j-1] == 0 where a[j] is the info accumulation."""
    cfg = vv009_config()
    npar, k, q = cfg.ldpc_parity_bits, cfg.nbch, cfg.q_ldpc
    rng = np.random.default_rng(4)
    info = rng.integers(0, 2, k).astype(np.uint8)
    parity = ldpc.encode_ref(info, cfg.frame_size, cfg.code_rate, npar, q)
    gather, _ = ldpc.encoder_gather(cfg.frame_size, cfg.code_rate, npar, k, q)
    ext = np.concatenate([info, [0]]).astype(np.int64)
    a = ext[gather].sum(1) & 1
    prev = np.concatenate([[0], parity[:-1]])
    assert ((a ^ parity ^ prev) == 0).all()


def test_crc8_table_linearity():
    tab = _crc8_byte_table()
    assert tab[0] == 0
    rng = np.random.default_rng(5)
    for _ in range(20):
        a, b = rng.integers(0, 256, 2)
        assert tab[a ^ b] == tab[a] ^ tab[b]


def test_packet_crc_matrix_matches_serial():
    tab = _crc8_byte_table()
    rng = np.random.default_rng(6)
    body = rng.integers(0, 256, 187, dtype=np.uint8)
    crc = 0
    for byte in body:
        crc = int(tab[byte ^ crc])
    bits = np.unpackbits(body).astype(np.int64)
    crc_bits = (bits @ packet_crc_matrix().astype(np.int64)) & 1
    expect = np.array([(crc >> (7 - n)) & 1 for n in range(8)])
    assert (crc_bits == expect).all()


def test_header_crc8_known_zero():
    assert (header_crc8_bits(np.zeros(72, np.uint8), False) == 0).all()


@pytest.mark.parametrize("frame_size,rate", [
    (fs, r) for fs in (FrameSize.SHORT, FrameSize.NORMAL)
    for r in (CodeRate.C1_3, CodeRate.C2_5, CodeRate.C1_2, CodeRate.C3_5,
              CodeRate.C2_3, CodeRate.C3_4, CodeRate.C4_5, CodeRate.C5_6)
    if not (fs == FrameSize.NORMAL and r in (CodeRate.C1_3, CodeRate.C2_5))
])
def test_ldpc_qc_roll_matches_scatter(frame_size, rate):
    """The quasi-cyclic roll schedule (the pipeline's encoder) must equal
    the scatter oracle for all 14 Annex-A tables: entry (r, a) XORs
    roll(group r, a//q) into column a%q of a (360, q) accumulator, and the
    prefix chain factors into in-row prefix + exclusive row scan."""
    cfg = T2Config(frame_size=frame_size, code_rate=rate, fec_blocks=1,
                   ti_blocks=1)
    npar, k, q = cfg.ldpc_parity_bits, cfg.nbch, cfg.q_ldpc
    cols_sched = ldpc.qc_entries(frame_size, rate, q)
    rng = np.random.default_rng(4)
    info = rng.integers(0, 2, k).astype(np.uint8)

    g = info.reshape(k // 360, 360)
    acc = np.zeros((360, q), dtype=np.uint8)
    for c, entries in enumerate(cols_sched):
        for (r, s) in entries:
            acc[:, c] ^= np.roll(g[r], s)
    incl = np.bitwise_xor.accumulate(acc, axis=1)       # in-row prefix
    row_tot = incl[:, -1]
    row_excl = np.concatenate([[0], np.bitwise_xor.accumulate(row_tot)[:-1]])
    p_qc = (incl ^ row_excl[:, None]).reshape(npar)

    p_scatter = ldpc.encode_ref(info, frame_size, rate, npar, q)
    assert (p_qc == p_scatter).all()


@pytest.mark.parametrize("frame_size,rate,frames", [
    (FrameSize.SHORT, CodeRate.C4_5, None),  # vv009: the plan's own F
    (FrameSize.NORMAL, CodeRate.C2_3, 132),  # nbch 43200
    (FrameSize.NORMAL, CodeRate.C3_4, 132),  # nbch 48600
], ids=["vv009", "normal_c2_3", "normal_c3_4"])
def test_xla_qc_ldpc_matches_oracle(frame_size, rate, frames):
    """The jitted LDPC slice schedule that bb_and_fec runs must equal the
    scatter oracle bit-for-bit on a batch of frames."""
    import jax
    import jax.numpy as jnp
    from dvbt2ll_tpu.pipeline import qc_ldpc_parity
    from dvbt2ll_tpu.plan import build_plan

    if frames is None:
        cfg = vv009_config()
        pp = build_plan(cfg, 1, strict=False).plps[0]
        cols, frames = pp.ldpc_cols, pp.fec_frames
    else:
        cfg = T2Config(frame_size=frame_size, code_rate=rate, fec_blocks=1,
                       ti_blocks=1)
        cols = ldpc.qc_entries(frame_size, rate, cfg.q_ldpc)
    nbch, plen, q = cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc
    rng = np.random.default_rng(11)
    nb = rng.integers(0, 2, (frames, nbch), dtype=np.uint8)
    par = np.asarray(jax.jit(
        lambda x: qc_ldpc_parity(cols, q, plen, x))(jnp.asarray(nb)))
    assert par.shape == (frames, plen) and par.dtype == np.uint8
    for i in sorted({0, frames // 2, frames - 1}):
        ref = ldpc.encode_ref(nb[i], cfg.frame_size, cfg.code_rate, plen, q)
        assert (par[i] == ref).all(), f"frame {i}"
