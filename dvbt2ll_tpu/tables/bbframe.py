"""BB frame construction tables (EN 302 755 section 5 / mode adaptation).

The reference builds BB frames byte-serially with two CRC-8 implementations
(lib/bbheaderbch_bb_impl.cc:222-270 bit-serial for the header, :399-417 +
:701-719 table-driven for the TS sync replacement).  CRC-8 is GF(2)-linear,
so both become small constant matrices and the whole stage is one gather +
one mod-2 matmul.

Stream contract: a transmit step processes frames whose TS byte phase is
known statically.  Each output byte slot consumes exactly one input byte;
slots at packet phase 0 carry the CRC-8 of the previous 187 bytes instead of
the 0x47 sync byte, so steps take 187 bytes of left context
(the executor carries that tail between steps).
"""
import functools

import numpy as np

from .sequences import bb_scrambler
from ..config import InBand, InputMode, T2Config

CRC_POLY = 0xAB  # reflected representation used bit-serially


def _crc8_byte_table() -> np.ndarray:
    """256-entry CRC-8 step table (poly 0xD5 MSB-first == reflected 0xAB);
    mirrors reference build_crc8_table (:222-240)."""
    tab = np.empty(256, dtype=np.uint8)
    for i in range(256):
        crc = 0
        for j in range(7, -1, -1):
            bit = (i >> j) & 1
            if bit ^ ((crc >> 7) & 1):
                crc = ((crc << 1) ^ 0xD5) & 0xFF
            else:
                crc = (crc << 1) & 0xFF
        tab[i] = crc
    return tab


@functools.lru_cache(maxsize=1)
def packet_crc_matrix() -> np.ndarray:
    """M uint8 (187*8, 8): CRC byte (bit 7 first) of a 187-byte packet body
    as a linear function of its bits (MSB-first byte order).

    crc_{j+1} = tab[b_j ^ crc_j]  =>  crc = sum_j T^{187-j}(b_j).
    """
    tab = _crc8_byte_table()
    # T as an 8x8 GF(2) matrix acting on byte bits (bit 7 = MSB).
    def as_bits(v):
        return np.array([(v >> (7 - n)) & 1 for n in range(8)], dtype=np.uint8)

    T = np.stack([as_bits(tab[1 << (7 - n)]) for n in range(8)])  # row n: T(e_n)
    M = np.zeros((187 * 8, 8), dtype=np.uint8)
    power = np.eye(8, dtype=np.uint8)  # T^0
    for j in range(186, -1, -1):
        power = (power @ T) & 1  # T^{187-j}
        M[j * 8 : (j + 1) * 8] = power
    return M


def header_crc8_bits(header72: np.ndarray, hieff: bool) -> np.ndarray:
    """Bit-serial header CRC-8 (reference add_crc8_bits :247-270): 8 bits
    appended LSB-of-state-first."""
    crc = 0
    for bit in header72:
        b = int(bit) ^ (crc & 1)
        crc >>= 1
        if b:
            crc ^= CRC_POLY
    if hieff:
        crc ^= 0x80
    return np.array([(crc >> n) & 1 for n in range(8)], dtype=np.uint8)


def _field_bits(value: int, width: int):
    return [(value >> n) & 1 for n in range(width - 1, -1, -1)]


def header_bits(cfg: T2Config, count: int, padding: int) -> np.ndarray:
    """The 80-bit BB header for a frame starting at TS byte phase ``count``;
    mirrors reference add_bbheader (:272-325)."""
    hieff = cfg.input_mode == InputMode.HIEFF
    ts_gs = 0b11            # TS_GS_TRANSPORT
    bits = [ts_gs >> 1, ts_gs & 1]
    bits += [1]             # sis_mis = single
    bits += [1]             # ccm_acm = CCM
    bits += [0]             # issyi not active
    bits += [0]             # npd not active
    bits += [0, 0]          # ro = 0
    bits += [0] * 8         # ISI (single input stream)
    upl = 188 * 8 if not hieff else 0
    bits += _field_bits(upl, 16)
    dfl = cfg.kbch - 80 - padding
    bits += _field_bits(dfl, 16)
    bits += _field_bits(0x47 if not hieff else 0, 8)
    syncd = 0 if count == 0 else (188 - count) * 8
    bits += _field_bits(syncd, 16)
    hdr = np.array(bits, dtype=np.uint8)
    assert hdr.size == 72
    return np.concatenate([hdr, header_crc8_bits(hdr, hieff)])


def inband_type_b_bits(ts_rate: int) -> np.ndarray:
    """104-bit in-band type B field (reference add_inband_type_b :327-355)."""
    bits = [0, 1]
    bits += [0] * 31   # CELL_ID etc. zeroed
    bits += [0] * 22
    bits += [0] * 2
    bits += [0] * 10
    bits += _field_bits(ts_rate, 27)
    bits += [0] * 10
    out = np.array(bits, dtype=np.uint8)
    assert out.size == 104
    return out


class BBFramePlan:
    """Static structure mapping a padded TS byte window to BB frame bits.

    For a step of ``n_frames`` FEC frames starting at TS packet phase 0:

      * NORMAL mode: each DF byte slot consumes one input byte; slots at
        packet phase 0 carry the CRC-8 of the previous 187 bytes instead
        of the 0x47 sync (reference :700-719).  The fast path computes
        every packet CRC with one mod-2 matmul and scatters the bits into
        the flat fresh-bit stream; the carry window provides the 187
        bytes of left context.
      * HIEFF mode: sync bytes are REMOVED (no CRC substitution,
        reference :671-688): the payload stream is the fresh packets
        reshaped (P, 188) with column 0 dropped.
      * In-band type B: the first frame of every fec_blocks group loses
        104 payload bits and appends the static in-band field before
        scrambling (reference :663-665, :690-693, :720-723).

    Everything stays affine - static slices and reshapes, no per-frame
    gather tables.

    ``start_phase`` is the TS byte phase (the reference's ``count``,
    lib/bbheaderbch_bb_impl.cc:661-719: 0 = the next input byte is a sync
    byte) at the step start.  Non-phase-invariant streams drift by
    ``payload % 188`` per step; a consumer that rebuilds the plan with
    ``start_phase = prev.next_phase`` gets bit-exact headers / CRC
    positions for EVERY step (tests/test_modes.py), at the cost of one
    compile per distinct phase.  HIEFF plans consume whole packets by
    construction and never drift.
    """

    def __init__(self, cfg: T2Config, n_frames: int, strict: bool = True,
                 start_phase: int = 0):
        self.cfg = cfg
        self.n_frames = n_frames
        nbytes = cfg.df_bytes
        self.hieff = cfg.input_mode == InputMode.HIEFF
        self.inband = cfg.in_band == InBand.ON
        k = cfg.fec_blocks
        if self.inband and n_frames % k:
            raise ValueError("in-band signalling needs whole T2-frame "
                             "groups of fec_blocks FEC frames per step")

        sizes = np.full(n_frames, nbytes, dtype=np.int64)
        if self.inband:
            sizes[::k] -= 13  # 104 bits of in-band field
        self.frame_bytes = sizes
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        total_payload = int(offsets[-1])
        self.payload_bytes = total_payload

        if self.hieff:
            if start_phase:
                raise ValueError("HIEFF plans consume whole packets and "
                                 "never drift; start_phase must be 0")
            if total_payload % 187:
                raise ValueError(
                    f"HIEFF steps must consume whole packets: payload "
                    f"{total_payload} is not a multiple of 187")
            self.n_packets = total_payload // 187
            self.ts_bytes_in = total_payload + self.n_packets
            self.phase_invariant = True  # whole packets enforced above
            self.start_phase = 0
            self.next_phase = 0
            self.sync_offset = 0
            self.sync_slots = np.zeros(0, dtype=np.int64)
            # count (input-stream packet phase) at each frame start
            p0 = offsets[:-1]
            rem = p0 % 187
            frame_counts = np.where(rem == 0, 0, rem + 1)
        else:
            self.ts_bytes_in = total_payload
            # phase-invariant = step N+1 starts at the SAME packet phase, so
            # the static headers / sync-slot layout hold for EVERY step; a
            # non-invariant plan covers one step at its start_phase (the
            # Transmitter refuses step 2 unless told otherwise)
            self.phase_invariant = total_payload % 188 == 0
            if strict and not self.phase_invariant:
                raise ValueError(
                    f"step payload ({total_payload}) must be a multiple of "
                    f"188 for a phase-invariant plan; raise batch_frames")
            self.start_phase = start_phase % 188
            self.next_phase = (self.start_phase + total_payload) % 188
            # index of the first sync slot in the fresh stream
            self.sync_offset = (188 - self.start_phase) % 188
            counts = (self.start_phase + np.arange(total_payload)) % 188
            self.sync_slots = np.where(counts == 0)[0]
            self.n_packets = len(self.sync_slots)
            frame_counts = (self.start_phase + offsets[:-1]) % 188

        headers = np.empty((n_frames, 80), dtype=np.uint8)
        for f in range(n_frames):
            padding = 104 if (self.inband and f % k == 0) else 0
            headers[f] = header_bits(cfg, int(frame_counts[f]), padding)
        self.headers = headers
        self.inband_bits = (inband_type_b_bits(cfg.ts_rate)
                            if self.inband else None)
        self.crc_matrix = packet_crc_matrix()
        self.scramble = bb_scrambler()[: cfg.kbch].copy()
