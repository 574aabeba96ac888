"""TransmitPlan: every static array the jitted transmit step consumes.

The reference implementation recomputes tables per block and walks the data
byte-by-byte (see SURVEY.md section 3.2).  Here the entire chain is composed
host-side into a handful of dense constants so the device graph is:

    packet-row unpack -> GF(2) matmul (packet CRC) -> column concat
    -> XOR (scramble) -> GF(2) matmul (BCH)
    -> quasi-cyclic roll schedule + factored prefix-XOR scan (LDPC)
    -> gather (bit interleave) -> integer gray map + rotation + Q-roll
    -> ONE gather (cell/time ilv o zigzag o freq ilv o carrier placement,
       all composed into grid_src) + pilot plane
    -> batched IFFT -> guard-interval slice -> P1 concat
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .config import T2Config
from .tables import cell_interleaver, freq_interleaver
from .tables.bbframe import BBFramePlan
from .tables.bch import parity_matrix
from .tables.l1 import l1post_cells_all_frames, l1pre_cells
from .tables.ldpc import qc_entries
from .tables.mapper import bit_permutation
from .tables.pilots import build_planes, p1_waveform
from .tables.sequences import bb_scrambler
from .config import FrameSize


def zigzag_map(cfg: T2Config) -> np.ndarray:
    """Z with frame[t] = seq[Z[t]]: the P2 zig-zag spread of L1 cells
    (reference lib/framemapperfint_cc_impl.cc:2064-2101); identity when
    N_P2 == 1."""
    m = cfg.mapped_cells
    if cfg.n_p2 == 1:
        return np.arange(m, dtype=np.int64)
    n_p2, c_p2 = cfg.n_p2, cfg.c_p2
    n_pre, n_post = 1840, cfg.l1post_cells
    z = np.empty(m, dtype=np.int64)
    pre_per = n_pre // n_p2
    post_per = n_post // n_p2
    fill = c_p2 - pre_per - post_per
    for n in range(n_p2):
        base = n * c_p2
        z[base : base + pre_per] = n + np.arange(pre_per) * n_p2
        z[base + pre_per : base + pre_per + post_per] = \
            n_pre + n + np.arange(post_per) * n_p2
        z[base + pre_per + post_per : base + c_p2] = \
            n_pre + n_post + n * fill + np.arange(fill)
    # after the P2 region the stream continues sequentially
    z[n_p2 * c_p2 :] = np.arange(n_p2 * c_p2, m)
    return z


def payload_frame_order(cfg: T2Config) -> Optional[np.ndarray]:
    """Frame-payload position -> PLP-major payload index (EN 302 755
    section 8.3.6): common and type-1 PLPs lie contiguous in config
    order, then the type-2 PLPs interleave as ``sub_slices`` rounds of
    one sub-slice per PLP.  None when the order is the identity (no
    type-2 PLPs), so existing single/multi-type-1 plans compose exactly
    as before."""
    types = cfg.plp_types
    if 2 not in types:
        return None
    starts = cfg.plp_starts
    sizes = [c.stream_cells for c in cfg.plp_configs]
    parts = [np.arange(starts[i], starts[i] + sizes[i], dtype=np.int64)
             for i, t in enumerate(types) if t != 2]
    t2 = [i for i, t in enumerate(types) if t == 2]
    for s in range(cfg.sub_slices):
        for i in t2:
            chunk = sizes[i] // cfg.sub_slices
            parts.append(np.arange(starts[i] + s * chunk,
                                   starts[i] + (s + 1) * chunk,
                                   dtype=np.int64))
    return np.concatenate(parts)


def interleaved_stream_to_seq(cfg: T2Config) -> np.ndarray:
    """Compose zig-zag + per-symbol frequency interleaving: position k of the
    symbol-major frequency-interleaved cell stream <- seq index."""
    z = zigzag_map(cfg)
    out = np.empty(cfg.mapped_cells, dtype=np.int64)
    pos = 0
    symbol = 0
    he, ho = freq_interleaver.build_h(cfg.fft_key, cfg.c_p2)
    for _ in range(cfg.n_p2):
        h = he if symbol % 2 == 0 else ho
        out[pos : pos + cfg.c_p2] = z[pos + h]
        pos += cfg.c_p2
        symbol += 1
    he, ho = freq_interleaver.build_h(cfg.fft_key, cfg.c_data)
    for _ in range(cfg.num_plain_data_symbols):
        h = he if symbol % 2 == 0 else ho
        out[pos : pos + cfg.c_data] = z[pos + h]
        pos += cfg.c_data
        symbol += 1
    if cfg.has_fc_symbol:
        he, ho = freq_interleaver.build_h(cfg.fft_key, cfg.n_fc)
        h = he if symbol % 2 == 0 else ho
        out[pos : pos + cfg.n_fc] = z[pos + h]
        pos += cfg.n_fc
    assert pos == cfg.mapped_cells
    return out


@dataclass
class PlpPlan:
    """Per-PLP constants for the bit/cell/time-interleave stages.

    The TS->DF map is affine (each DF byte slot consumes one input byte,
    the step starts at packet phase 0), so there are no per-frame gather
    tables: DF bits are the fresh bits reshaped, packet bodies are a
    strided view of the padded bits, and only the CRC scatter indices
    (one per packet) are materialized.
    """

    cfg: T2Config                      # effective per-PLP chain config
    fec_frames: int                    # FEC frames per step for this PLP
    bb: object = field(repr=False, default=None)                 # BBFramePlan
    headers: np.ndarray = field(repr=False, default=None)        # (F, 80) u8
    n_packets: int = 0                                           # P
    crc_matrix: np.ndarray = field(repr=False, default=None)     # (1496, 8) i8
    crc_scatter: np.ndarray = field(repr=False, default=None)    # (P*8,) i32
    scramble: np.ndarray = field(repr=False, default=None)       # (kbch,) u8
    bch_matrix: np.ndarray = field(repr=False, default=None)     # (kbch, npar) i8
    # QC-roll schedule: per accumulator column, [(group row, roll)]
    ldpc_cols: tuple = field(repr=False, default=None)
    mapper_perm: np.ndarray = field(repr=False, default=None)    # (N,) i32
    ti_perm: np.ndarray = field(repr=False, default=None)        # (stream,) i32

    @property
    def ts_bytes_in(self) -> int:
        """Fresh TS bytes consumed per step (excludes the 187-byte carry)."""
        return self.bb.ts_bytes_in


@dataclass
class TransmitPlan:
    """All constants for a jitted transmit step over a batch of T2 frames."""

    cfg: T2Config
    batch_frames: int                  # T2 frames per step

    # per-PLP bit/cell/TI stages (one entry for a single-PLP config)
    plps: list = field(repr=False, default=None)                 # [PlpPlan]
    # frame domain
    l1pre: np.ndarray = field(repr=False, default=None)          # (1840,) c64
    l1post_all: np.ndarray = field(repr=False, default=None)     # (T, l1c) c64
    dummy: np.ndarray = field(repr=False, default=None)          # (dummy,) c64
    # sample domain
    grid_src: np.ndarray = field(repr=False, default=None)       # (S, fft) i32
    pilot_plane: np.ndarray = field(repr=False, default=None)    # (S, fft) f32
    eq: Optional[np.ndarray] = field(repr=False, default=None)   # (fft,) f32
    p1: np.ndarray = field(repr=False, default=None)             # (2048,) c64
    fef_part: Optional[np.ndarray] = field(repr=False, default=None)  # c64

    @property
    def fec_frames(self) -> int:
        """FEC frames per step of the first PLP (single-PLP convenience)."""
        return self.batch_frames * self.cfg.plp_configs[0].fec_blocks

    @property
    def ts_bytes_in(self) -> int:
        """Fresh TS bytes per step of the first PLP (single-PLP
        convenience; multi-PLP callers use ts_bytes_per_plp)."""
        return self.plps[0].ts_bytes_in

    @property
    def ts_bytes_per_plp(self) -> tuple:
        return tuple(pp.ts_bytes_in for pp in self.plps)

    @property
    def samples_out(self) -> int:
        return self.batch_frames * self.cfg.samples_per_frame


def min_batch_frames(cfg: T2Config) -> int:
    """Smallest T2-frame batch with whole TS packets per step (phase 0)
    for every PLP."""
    from .config import InBand, InputMode
    b = 1
    for c in cfg.plp_configs:
        per_t2 = c.fec_blocks * c.df_bytes
        if c.in_band == InBand.ON:
            per_t2 -= 13
        align = 187 if c.input_mode == InputMode.HIEFF else 188
        g = np.gcd(per_t2, align)
        b = int(np.lcm(b, align // g))
    return b


def _build_plp_plan(cfg_plp: T2Config, batch_frames: int,
                    strict: bool, start_phase: int = 0) -> PlpPlan:
    n_fec = batch_frames * cfg_plp.fec_blocks
    pp = PlpPlan(cfg=cfg_plp, fec_frames=n_fec)
    bb = BBFramePlan(cfg_plp, n_fec, strict=strict, start_phase=start_phase)
    pp.bb = bb
    pp.headers = bb.headers
    pp.n_packets = bb.n_packets
    pp.crc_matrix = bb.crc_matrix.astype(np.int8)
    # CRC bit b of packet p overwrites flat DF bit sync_slot*8 + b
    pp.crc_scatter = (bb.sync_slots[:, None] * 8
                      + np.arange(8)[None, :]).reshape(-1).astype(np.int32)
    pp.scramble = bb.scramble
    pp.bch_matrix = parity_matrix(
        cfg_plp.kbch, cfg_plp.frame_size == FrameSize.SHORT,
        cfg_plp.bch_t).astype(np.int8)
    pp.ldpc_cols = qc_entries(cfg_plp.frame_size, cfg_plp.code_rate,
                              cfg_plp.q_ldpc)
    pp.mapper_perm = bit_permutation(cfg_plp)
    pp.ti_perm = cell_interleaver.interleaver_permutation(cfg_plp)
    return pp


def build_plan(cfg: T2Config, batch_frames: Optional[int] = None,
               strict: bool = True, start_phases=0) -> TransmitPlan:
    """start_phases: TS byte phase at the step start, one int shared by all
    PLPs or a per-PLP sequence (see BBFramePlan; 0 = packet-aligned).
    Non-phase-invariant streaming consumers rebuild the plan per step with
    ``pp.bb.next_phase`` to keep headers/CRC positions bit-exact."""
    cfg.validate()
    if batch_frames is None:
        batch_frames = min_batch_frames(cfg)
    plan = TransmitPlan(cfg=cfg, batch_frames=batch_frames)

    # ---- per-PLP bit/cell/TI stages --------------------------------------
    phases = (list(start_phases)
              if isinstance(start_phases, (list, tuple, np.ndarray))
              else [start_phases] * len(cfg.plp_configs))
    assert len(phases) == len(cfg.plp_configs)
    plan.plps = [_build_plp_plan(c, batch_frames, strict, start_phase=q)
                 for c, q in zip(cfg.plp_configs, phases)]

    # ---- frame domain -----------------------------------------------------
    plan.l1pre = l1pre_cells(cfg)
    plan.l1post_all = l1post_cells_all_frames(cfg)
    dummy_bits = bb_scrambler(max(cfg.dummy_cells, 1))[: cfg.dummy_cells]
    plan.dummy = (1.0 - 2.0 * dummy_bits.astype(np.float32)).astype(
        np.complex64)

    # ---- sample domain ----------------------------------------------------
    src_grid, pilot_grid, cells_per_symbol = build_planes(cfg)
    expected = ([cfg.c_p2] * cfg.n_p2
                + [cfg.c_data] * cfg.num_plain_data_symbols
                + ([cfg.n_fc] if cfg.has_fc_symbol else []))
    assert cells_per_symbol.tolist() == expected, (
        cells_per_symbol.tolist(), expected)
    stream_to_seq = interleaved_stream_to_seq(cfg)
    # Compose the per-PLP cell/time interleavers into the grid gather too:
    # the payload region of seq then holds RAW mapper-output cells, so the
    # jitted step never materializes the (B, stream) interleaved payload.
    from .config import N_L1PRE_CELLS
    pre_post = N_L1PRE_CELLS + cfg.l1post_cells
    ti_full = np.concatenate(
        [start + pp.ti_perm.astype(np.int64)
         for start, pp in zip(cfg.plp_starts, plan.plps)])
    # type-2 sub-slicing re-orders the frame's payload region (common /
    # type-1 first, then interleaved sub-slices); compose it in front of
    # the per-PLP interleavers so frame position q reads raw mapper cell
    # ti_full[order[q]]
    order = payload_frame_order(cfg)
    if order is not None:
        ti_full = ti_full[order]
    pay = ((stream_to_seq >= pre_post)
           & (stream_to_seq < pre_post + cfg.total_stream_cells))
    stream_to_seq[pay] = pre_post + ti_full[stream_to_seq[pay] - pre_post]
    grid = src_grid.astype(np.int64)
    valid = grid >= 0
    grid[valid] = stream_to_seq[grid[valid]]
    plan.grid_src = np.where(valid, grid, -1).astype(np.int32)
    plan.pilot_plane = pilot_grid
    if cfg.equalization:
        from .tables.pilots import inverse_sinc
        plan.eq = inverse_sinc(cfg)
    plan.p1 = p1_waveform(cfg)
    if cfg.has_fef:
        from .tables.pilots import fef_part_waveform
        plan.fef_part = fef_part_waveform(cfg)
    return plan
