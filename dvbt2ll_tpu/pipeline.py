"""The jitted DVB-T2 transmit pipeline.

One XLA program turns windows of TS bytes (one per PLP) into baseband IQ
for a batch of T2 frames.  Covers the full fused chain of the reference's
four stream blocks plus the in-tree LDPC encoder it relies on (see
SURVEY.md section 0), generalized to multi-PLP frames.  All tables come
from a host-built :class:`~dvbt2ll_tpu.plan.TransmitPlan`.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .config import T2Config
from .plan import PlpPlan, TransmitPlan, build_plan, min_batch_frames


def _plp_consts(pp: PlpPlan):
    """Trace-ready per-PLP constants, cached as HOST numpy arrays.

    They stay numpy deliberately: jit bakes closure constants into the
    compiled executable at trace time, so there is no per-call upload on
    the hot path.
    """
    c = getattr(pp, "_trace_consts", None)
    if c is None:
        c = {
            "headers": np.asarray(pp.headers, np.uint8),
            "headers_b": np.packbits(np.asarray(pp.headers, np.uint8),
                                     axis=1),
            "crc_matrix": np.asarray(pp.crc_matrix, np.int8),
            "scramble": np.asarray(pp.scramble, np.uint8),
            "scramble_b": np.packbits(np.asarray(pp.scramble, np.uint8)),
            "bch_matrix": np.asarray(pp.bch_matrix, np.int8),
            "mapper_perm": np.asarray(pp.mapper_perm, np.int32),
            "ti_perm": np.asarray(pp.ti_perm, np.int32),
            "inband_b": (None if pp.bb.inband_bits is None
                         else np.packbits(
                             np.asarray(pp.bb.inband_bits, np.uint8))),
        }
        pp._trace_consts = c
    return c


def _consts(plan: TransmitPlan):
    """Trace-ready frame/sample-domain constants (host numpy, see above)."""
    c = getattr(plan, "_trace_consts", None)
    if c is None:
        c = {
            "l1pre": np.asarray(plan.l1pre, np.complex64),
            "l1post_all": np.asarray(plan.l1post_all, np.complex64),
            "dummy": np.asarray(plan.dummy, np.complex64),
            "grid_src": np.asarray(plan.grid_src, np.int32),
            "pilot_plane": np.asarray(plan.pilot_plane, np.float32),
            "eq": (None if plan.eq is None
                   else np.asarray(plan.eq, np.float32)),
            "p1": np.asarray(plan.p1, np.complex64),
            "fef_part": (None if plan.fef_part is None
                         else np.asarray(plan.fef_part, np.complex64)),
        }
        plan._trace_consts = c
    return c


def _planar_consts(plan: TransmitPlan):
    """Planar-tail constants (host numpy): re/im planes of every complex
    constant plus the TRANSPOSED-GRID gather map and pilot plane for the
    4-step IFFT+GI tail (ops/ifft4.py): element [s, k2, k1] of the
    transposed layout holds carrier bin N2*k1 + k2."""
    c = getattr(plan, "_planar_consts_cache", None)
    if c is None:
        from .ops.ifft4 import N1
        cc = _consts(plan)
        fft = plan.cfg.fft_points
        n2 = fft // N1
        # natural (S, fft) -> transposed (S, n2, N1)
        tidx = (n2 * np.arange(N1)[None, :]
                + np.arange(n2)[:, None])          # (n2, N1)
        c = {
            "l1pre_re": np.float32(cc["l1pre"].real),
            "l1pre_im": np.float32(cc["l1pre"].imag),
            "l1post_re": np.float32(cc["l1post_all"].real),
            "l1post_im": np.float32(cc["l1post_all"].imag),
            "dummy_re": np.float32(cc["dummy"].real),
            "dummy_im": np.float32(cc["dummy"].imag),
            "p1_re": np.float32(cc["p1"].real),
            "p1_im": np.float32(cc["p1"].imag),
            "grid_src_t": np.ascontiguousarray(cc["grid_src"][:, tidx]),
            "pilot_t": np.ascontiguousarray(cc["pilot_plane"][:, tidx]),
            "eq_t": (None if cc["eq"] is None
                     else np.ascontiguousarray(
                         np.broadcast_to(cc["eq"], (1, fft))[:, tidx])),
        }
        plan._planar_consts_cache = c
    return c


# Each stage traces under a jax.named_scope: the labels
# tools/trace_report.py groups device time by.
@jax.named_scope("fec")
def bb_and_fec(pp: PlpPlan, ts_padded: jnp.ndarray) -> jnp.ndarray:
    """TS bytes (187 carry + fresh) -> LDPC frame bits (F, frame_bits) u8.

    The TS->DF byte map is affine (the packet phase at the step start is
    static, BBFramePlan.start_phase), so this is all reshapes and static
    slices - no per-frame gather tables
    (which would grow O(batch) and dwarf the data).  NORMAL mode replaces
    sync bytes with packet CRCs via one matmul + scatter; HIEFF mode drops
    the sync column of the packet-major reshape; in-band frames lose 104
    payload bits and append the static in-band field.
    """
    cfg = pp.cfg
    bb = pp.bb
    c = _plp_consts(pp)
    f, p = pp.fec_frames, pp.n_packets
    # The TS->DF re-chunking (packet-major -> frame-major) stays in the
    # BYTE domain: packet rows and data fields are both whole numbers of
    # bytes, so the flatten/reshape shuffles move 8x fewer bytes than a
    # bit-domain assembly would.  Bits are only unpacked (a) per packet
    # for the CRC-8 matmul input and (b) once per FRAME-ALIGNED kbch row
    # after scrambling - wide 2D rows both times.
    nb = ts_padded.shape[0]
    nfresh = nb - 187

    if bb.hieff:
        # payload = fresh packets with the sync column removed
        stream_b = ts_padded[187:].reshape(p, 188)[:, 1:].reshape(-1)
    elif p == 0:
        # window so short (or phase so late) that it contains no sync slot:
        # the whole payload passes through unmodified
        stream_b = ts_padded[187:]
    else:
        # o = fresh-stream index of the first sync slot: 0 for packet-
        # aligned (phase-0) plans, (188 - start_phase) % 188 for drifted
        # per-phase plans (BBFramePlan.start_phase)
        o = bb.sync_offset
        aligned = jnp.pad(
            ts_padded[187 + o:], (0, p * 188 - (nfresh - o))).reshape(p, 188)
        # sync slot i sits at fresh byte o + 188*i; its CRC covers the 187
        # payload bytes before it: for i=0 the carry-window tail, for i>0
        # packet row i-1 minus its sync slot
        pkt_b = jnp.concatenate(
            [ts_padded[o : o + 187][None], aligned[:-1, 1:]], axis=0)
        pkt = jnp.unpackbits(pkt_b, axis=1).astype(jnp.int8)  # (p, 1496)
        crc = (jnp.matmul(pkt, c["crc_matrix"],
                          preferred_element_type=jnp.int32) & 1
               ).astype(jnp.uint8)
        crc_byte = jnp.packbits(crc, axis=1)                  # (p, 1)
        groups = jnp.concatenate([crc_byte, aligned[:, 1:]],
                                 axis=1).reshape(-1)
        if o:
            stream_b = jnp.concatenate(
                [ts_padded[187 : 187 + o], groups])[:nfresh]
        else:
            stream_b = groups[:nfresh]

    kbch_b = cfg.kbch // 8
    if not bb.inband:
        df = stream_b.reshape(f, kbch_b - 10)
        kb_bytes = jnp.concatenate([c["headers_b"], df], axis=1)
    else:
        # first frame of each fec_blocks group: 13 fewer payload bytes,
        # static 104-bit in-band field appended (reference :690-693)
        k = cfg.fec_blocks
        b = f // k
        d_bytes = kbch_b - 10
        g_bytes = k * d_bytes - 13
        groups = stream_b.reshape(b, g_bytes)
        hdrs = c["headers_b"].reshape(b, k, 10)
        ib = jnp.tile(c["inband_b"][None, :], (b, 1))
        kb0 = jnp.concatenate(
            [hdrs[:, 0], groups[:, : d_bytes - 13], ib], axis=1)
        rest = groups[:, d_bytes - 13:].reshape(b, k - 1, d_bytes)
        kbr = jnp.concatenate([hdrs[:, 1:], rest], axis=2)
        kb_bytes = jnp.concatenate(
            [kb0[:, None], kbr], axis=1).reshape(f, kbch_b)

    kb_bytes = kb_bytes ^ c["scramble_b"][None, :]
    kbch_bits = jnp.unpackbits(kb_bytes, axis=1)          # (f, kbch)

    bch_par = (jnp.matmul(kbch_bits.astype(jnp.int8), c["bch_matrix"],
                          preferred_element_type=jnp.int32) & 1).astype(
                              jnp.uint8)
    nbch_bits = jnp.concatenate([kbch_bits, bch_par], axis=1)  # (F, nbch)

    ldpc_par = qc_ldpc_parity(pp.ldpc_cols, cfg.q_ldpc,
                              cfg.ldpc_parity_bits, nbch_bits)
    return jnp.concatenate([nbch_bits, ldpc_par], axis=1)


@jax.named_scope("ldpc")
def qc_ldpc_parity(ldpc_cols, q: int, plen: int,
                   nbch_bits: jnp.ndarray) -> jnp.ndarray:
    """BCH codewords (F, nbch) u8 bits -> LDPC parity (F, plen) u8 bits.

    Uses the quasi-cyclic structure (tables/ldpc.qc_entries): with the
    accumulator laid out (360, q) [parity p -> (p//q, p%q)], Annex-A entry
    (r, a) XORs roll(info group r, a//q) into column a%q - a fully static
    schedule of 85-648 rolls, no gather tables.  The final chain
    p[j] ^= p[j-1] factors into an in-row (q-wide) inclusive prefix plus
    an exclusive log-depth scan over the 360 rows.
    """
    f, nbch = nbch_bits.shape
    g = nbch_bits.reshape(f, nbch // 360, 360)
    # rolls as static slices of a doubled copy: one op per entry instead of
    # roll's slice+slice+concat (2.3x faster compile, same runtime)
    g2 = jnp.concatenate([g, g], axis=2)
    cols = []
    for entries in ldpc_cols:
        acc = None
        for (r, s) in entries:
            t = g2[:, r, 360 - s : 720 - s]
            acc = t if acc is None else acc ^ t
        cols.append(acc if acc is not None
                    else jnp.zeros((f, 360), jnp.uint8))
    run = cols[0]
    incl = [run]
    for cc in range(1, q):
        run = run ^ cols[cc]
        incl.append(run)
    incl = jnp.stack(incl, axis=2)                       # (F, 360, q)
    row_inc = jax.lax.associative_scan(jnp.bitwise_xor, run, axis=1)
    row_excl = jnp.concatenate(
        [jnp.zeros((f, 1), jnp.uint8), row_inc[:, :-1]], axis=1)
    return (incl ^ row_excl[:, :, None]).reshape(f, plen)


@jax.named_scope("map")
def map_cells_planes(pp: PlpPlan, frame_bits: jnp.ndarray):
    """LDPC frames -> constellation cell I/Q planes ((F, cell),(F, cell)).

    The gray-coded square QAM of EN 302 755 section 6.2 has the closed
    form A = s0*(2^(h-1) + s1*(2^(h-2) + ... + s_(h-1))) per axis with
    s_k = 1-2b_k (I from even cell-word bits, Q from odd), verified
    against the reference's LUTs (lib/interleavermod_bc_impl.cc:169-253)
    in tests.  Evaluating it elementwise needs no 2^mod-entry complex LUT
    gather.  Planes stay separate so the planar tail never materializes
    complex64.
    """
    cfg = pp.cfg
    c = _plp_consts(pp)
    mod = cfg.mod_bits
    h = mod // 2
    f = frame_bits.shape[0]
    # 2D index -> the gather lands directly in (F, cell, mod) shape, with
    # no separate reshape of the whole bit tensor
    perm2d = c["mapper_perm"].reshape(cfg.cell_size, mod)
    cell_bits = frame_bits[:, perm2d]

    def axis_level(bv):  # bv: (F, CS, h) u8 bits, MSB first
        # A = s0*(2^(h-1) + s1*(2^(h-2) + ...)) with s=1-2b expands to
        # sum_k 2^(h-1-k) * prod_{j<=k} s_j, and a product of signs is the
        # XOR of their bits: A = (2^h - 1) - 2*G with G the packed prefix
        # XOR.  Integer u8 ops until one final float convert.
        acc = bv[..., 0]
        g = acc
        for k in range(1, h):
            acc = acc ^ bv[..., k]
            g = (g << 1) | acc
        return float((1 << h) - 1) - 2.0 * g.astype(jnp.float32)

    norm = float(np.sqrt({2: 2.0, 4: 10.0, 6: 42.0, 8: 170.0}[mod]))
    i_level = axis_level(cell_bits[..., 0::2]) * (1.0 / norm)
    q_level = axis_level(cell_bits[..., 1::2]) * (1.0 / norm)
    if cfg.rotation:
        ang = math.radians(cfg.rotation_angle_deg)
        cos_t, sin_t = math.cos(ang), math.sin(ang)
        i_rot = i_level * cos_t - q_level * sin_t
        q_rot = i_level * sin_t + q_level * cos_t
        # cyclic Q delay of one cell within the codeword
        return i_rot, jnp.roll(q_rot, 1, axis=1)
    return i_level, q_level


def map_cells(pp: PlpPlan, frame_bits: jnp.ndarray) -> jnp.ndarray:
    """LDPC frames -> constellation cells (F, cell_size) c64."""
    i_p, q_p = map_cells_planes(pp, frame_bits)
    return jax.lax.complex(i_p, q_p)


def ti_payload(pp: PlpPlan, cells: jnp.ndarray, batch: int) -> jnp.ndarray:
    """FEC-frame cells (F, cell) -> cell/time-interleaved (B, stream).

    Reference semantics (framemapperfint :1973-2028) kept for per-stage
    verification; the jitted step does NOT call this — the TI permutation
    is composed into ``grid_src`` at plan-build time instead.
    """
    c = _plp_consts(pp)
    stream = cells.reshape(batch, pp.cfg.stream_cells)
    return stream[:, c["ti_perm"]]


@jax.named_scope("frame_build")
def build_frames(plan: TransmitPlan, payload: jnp.ndarray,
                 frame_idx0: jnp.ndarray) -> jnp.ndarray:
    """RAW mapper-output cells (B, total_stream) -> OFDM grids (B, S, fft).

    ``grid_src`` composes zig-zag + frequency interleaving + carrier
    placement + the per-PLP cell/time interleavers, so one gather goes
    straight from mapper output order to (symbol, carrier)."""
    cfg = plan.cfg
    c = _consts(plan)
    b = plan.batch_frames

    idx = (frame_idx0 + jnp.arange(b)) % cfg.t2_frames
    l1post = jnp.asarray(c["l1post_all"])[idx]  # (B, l1cells)
    # one trailing zero cell absorbs every pilot/null position: the gather
    # needs no mask pass (grid_src == -1 indexes the sentinel)
    seq = jnp.concatenate([
        jnp.tile(c["l1pre"][None, :], (b, 1)),
        l1post,
        payload,
        jnp.tile(c["dummy"][None, :], (b, 1)),
        jnp.zeros((b, cfg.n_fc - cfg.c_fc + 1), jnp.complex64),
    ], axis=1)

    src = c["grid_src"]
    gather = jnp.where(src >= 0, src, seq.shape[1] - 1)
    return seq[:, gather] + c["pilot_plane"].astype(jnp.complex64)


@jax.named_scope("ofdm")
def modulate(plan: TransmitPlan, grids: jnp.ndarray) -> jnp.ndarray:
    """(B, S, fft) grids -> (B, samples_per_frame) IQ."""
    cfg = plan.cfg
    c = _consts(plan)
    fft = cfg.fft_points
    gi = cfg.guard_samples
    if c["eq"] is not None:  # inverse-sinc pre-equalization
        grids = grids * c["eq"]
    time = jnp.fft.ifft(grids, axis=-1) * (fft * cfg.ofdm_normalization)
    time = time.astype(jnp.complex64)
    with_gi = jnp.concatenate([time[..., fft - gi :], time], axis=-1)
    b = grids.shape[0]
    body = with_gi.reshape(b, cfg.num_symbols * (fft + gi))
    p1 = jnp.tile(c["p1"][None, :], (b, 1))
    return jnp.concatenate([p1, body], axis=1)


def transmit_step_iq_planar(plan: TransmitPlan, ts_padded,
                            frame_idx0) -> jnp.ndarray:
    """The planar-f32 tail: identical math to transmit_step_iq but
    complex64 never materializes - cells, frame grids and the OFDM tail
    stay as separate re/im f32 planes, and the frame builder gathers
    straight into the 4-step IFFT's transposed (N2, 128) layout so the
    transform's result rows land in natural sample order (GI = whole-row
    concat, no output transpose; ops/ifft4.py).  select_step_iq decides
    where it runs."""
    from .ops.ifft4 import ifft_gi_einsum

    cfg = plan.cfg
    c = _consts(plan)
    pc = _planar_consts(plan)
    b = plan.batch_frames

    res, ims = [], []
    for pp, w in zip(plan.plps, _as_windows(plan, ts_padded)):
        frame_bits = bb_and_fec(pp, w)
        i_p, q_p = map_cells_planes(pp, frame_bits)
        res.append(i_p.reshape(b, pp.cfg.stream_cells))
        ims.append(q_p.reshape(b, pp.cfg.stream_cells))
    pay_re = res[0] if len(res) == 1 else jnp.concatenate(res, axis=1)
    pay_im = ims[0] if len(ims) == 1 else jnp.concatenate(ims, axis=1)

    idx = (frame_idx0 + jnp.arange(b)) % cfg.t2_frames
    zeros = jnp.zeros((b, cfg.n_fc - cfg.c_fc + 1), jnp.float32)
    seq_re = jnp.concatenate([
        jnp.tile(pc["l1pre_re"][None, :], (b, 1)),
        jnp.asarray(pc["l1post_re"])[idx], pay_re,
        jnp.tile(pc["dummy_re"][None, :], (b, 1)), zeros], axis=1)
    seq_im = jnp.concatenate([
        jnp.tile(pc["l1pre_im"][None, :], (b, 1)),
        jnp.asarray(pc["l1post_im"])[idx], pay_im,
        jnp.tile(pc["dummy_im"][None, :], (b, 1)), zeros], axis=1)

    src = pc["grid_src_t"]
    gather = jnp.where(src >= 0, src, seq_re.shape[1] - 1)
    g_re = seq_re[:, gather] + pc["pilot_t"]        # (B, S, n2, N1)
    g_im = seq_im[:, gather]
    if pc["eq_t"] is not None:
        g_re = g_re * pc["eq_t"]
        g_im = g_im * pc["eq_t"]

    body_re, body_im = ifft_gi_einsum(
        g_re, g_im, cfg.fft_points, cfg.guard_samples,
        cfg.ofdm_normalization)
    p1r = jnp.tile(pc["p1_re"][None, :], (b, 1))
    p1i = jnp.tile(pc["p1_im"][None, :], (b, 1))
    out_re = jnp.concatenate([p1r, body_re.reshape(b, -1)], axis=1)
    out_im = jnp.concatenate([p1i, body_im.reshape(b, -1)], axis=1)
    return jnp.stack([out_re, out_im], axis=-1)


def _as_windows(plan: TransmitPlan, ts_padded) -> List[jnp.ndarray]:
    if isinstance(ts_padded, (list, tuple)):
        ws = list(ts_padded)
    else:
        ws = [ts_padded]
    assert len(ws) == len(plan.plps), (len(ws), len(plan.plps))
    return ws


def transmit_step(plan: TransmitPlan, ts_padded,
                  frame_idx0) -> jnp.ndarray:
    """Full chain: padded TS windows (one per PLP) -> (B, samples) c64."""
    payloads = []
    for pp, w in zip(plan.plps, _as_windows(plan, ts_padded)):
        frame_bits = bb_and_fec(pp, w)
        cells = map_cells(pp, frame_bits)
        payloads.append(cells.reshape(plan.batch_frames,
                                      pp.cfg.stream_cells))
    payload = (payloads[0] if len(payloads) == 1
               else jnp.concatenate(payloads, axis=1))
    grids = build_frames(plan, payload, frame_idx0)
    return modulate(plan, grids)


def transmit_step_iq(plan: TransmitPlan, ts_padded,
                     frame_idx0) -> jnp.ndarray:
    """Like transmit_step but returns float32 (B, samples, 2) I/Q planes:
    interleaved I/Q, the cf32 layout sinks write (callers can
    .view(complex64) on the host side).
    """
    out = transmit_step(plan, ts_padded, frame_idx0)
    with jax.named_scope("iq_out"):
        return jnp.stack([jnp.real(out), jnp.imag(out)], axis=-1)


#: The OFDM tail each platform runs: "complex" is transmit_step_iq
#: (jnp.fft.ifft, GI concat, stack(re, im)); "planar" is
#: transmit_step_iq_planar (f32 4-step einsums) wherever ops.ifft4.supported
#: admits the geometry.  Each entry is a measurement (tools/ab_tail.py,
#: PERF.md): on an H100 the planar tail took 1.6-2.2x the complex tail's
#: step time at vv009/256, 8k_normal/256 and 32k_extended/128.  A platform
#: that was never measured has no entry.
STEP_TAIL = {"cpu": "complex", "gpu": "complex"}


def select_step_iq(cfg: T2Config, platform: str):
    """The one place that chooses the step formulation: returns
    (step_fn, planar_tail) for ``platform`` (a ``jax.Device.platform``).
    Transmitter, ShardedTransmitter and everything built on them call
    this, so sequential and sharded runs on one platform make the same
    choice (the sharded == sequential bit-identity invariant)."""
    from .ops.ifft4 import supported

    tail = STEP_TAIL.get(platform)
    if tail is None:
        raise ValueError(
            f"no step formulation has been chosen for platform "
            f"{platform!r} (known: {sorted(STEP_TAIL)})")
    planar = tail == "planar" and supported(cfg.fft_points,
                                            cfg.guard_samples)
    return (transmit_step_iq_planar if planar else transmit_step_iq), planar


def default_platform() -> str:
    """Platform of the default device (a jax.default_device context or
    the jax_default_device setting included)."""
    d = jax.config.jax_default_device or jax.devices()[0]
    if isinstance(d, str):
        d = jax.devices(d)[0]
    return d.platform


class Transmitter:
    """Streaming DVB-T2 transmitter: feed TS bytes, get baseband IQ.

    Holds the tiny cross-step state the reference carries in block members
    (TS byte phase / CRC via the 187-byte carry window per PLP, and the T2
    frame counter; see SURVEY.md section 3.3).
    """

    def __init__(self, cfg: T2Config, batch_frames: Optional[int] = None,
                 strict: bool = True, validate_ts: bool = False,
                 allow_phase_drift: bool = False, start_phases=0):
        from .observability import TxCounters

        self.cfg = cfg
        # start_phases: TS byte phase at the step start (build_plan); lets
        # a non-phase-invariant stream be driven bit-exactly with one
        # Transmitter per distinct phase (start_phases=prev.bb.next_phase)
        self.plan = build_plan(cfg, batch_frames, strict=strict,
                               start_phases=start_phases)
        # decided AT CONSTRUCTION TIME from the default device: a
        # jax.default_device context must wrap construction, not just
        # the calls
        step_fn, self._planar_tail = select_step_iq(cfg, default_platform())
        self._carries = [np.zeros(187, dtype=np.uint8)
                         for _ in self.plan.plps]
        self._frame_idx = 0
        self._steps_done = 0
        self._phase_invariant = all(pp.bb.phase_invariant
                                    for pp in self.plan.plps)
        self._allow_phase_drift = allow_phase_drift
        self._validate_ts = validate_ts
        self.counters = TxCounters()
        for pp in self.plan.plps:
            _plp_consts(pp)
        _consts(self.plan)
        self._step = jax.jit(functools.partial(step_fn, self.plan))

    @property
    def bytes_per_step(self) -> int:
        """Fresh TS bytes per step (first PLP; see bytes_per_step_per_plp)."""
        return self.plan.ts_bytes_in

    @property
    def bytes_per_step_per_plp(self) -> tuple:
        return self.plan.ts_bytes_per_plp

    def _check_streamable(self) -> None:
        """Non-strict plans whose step payload is not a whole number of TS
        packets would start step 2 at a drifted packet phase and silently
        emit wrong BB headers / CRC positions - refuse instead (the
        reference's stream state, lib/bbheaderbch_bb_impl.cc:661-732, is
        resolved statically here and only phase-0 step starts are planned).

        allow_phase_drift=True opts out EXPLICITLY: every step is then
        treated as an independent phase-0 stream (mechanism tests and
        throughput benchmarks) - the concatenated output is NOT a valid
        continuous DVB-T2 stream for the given TS input.
        """
        if (self._steps_done and not self._phase_invariant
                and not self._allow_phase_drift):
            raise RuntimeError(
                f"this plan is single-shot: its step payload is not a "
                f"multiple of the TS packet length, so a second step would "
                f"start at a drifted packet phase and emit wrong BB "
                f"headers; build with strict=True or batch_frames="
                f"min_batch_frames(cfg) (= {min_batch_frames(self.cfg)}) "
                f"for streaming, or drive per-phase plans directly "
                f"(build_plan(start_phases=bb.next_phase), one compile per "
                f"distinct phase)")

    def step_window(self, windows) -> jax.Array:
        """One step from pre-carried (187 + fresh) byte windows - the public
        entry for external carry keepers like the native TS ingest ring
        (``TSIngest.window``).  Updates the stream state (carry, frame
        counter, counters) exactly like :meth:`step_device`.

        windows: (187 + bytes_per_step,) uint8 for single PLP, or a
        sequence of per-PLP windows.  Returns the float32 (B, samples, 2)
        I/Q device array.
        """
        import time as _time

        ws = (list(windows) if isinstance(windows, (list, tuple))
              else [windows])
        assert len(ws) == len(self.plan.plps)
        self._check_streamable()
        t0 = _time.perf_counter()
        padded = []
        nbytes = 0
        for i, (pp, w) in enumerate(zip(self.plan.plps, ws)):
            w = np.asarray(w, dtype=np.uint8)
            assert w.shape == (187 + pp.ts_bytes_in,), (
                w.shape, 187 + pp.ts_bytes_in)
            if self._validate_ts:
                from .observability import check_ts_sync
                # drifted per-phase plans start mid-packet: the sync slots
                # of this window sit at the plan's start_phase, not 0
                self.counters.sync_errors += check_ts_sync(
                    w[187:], phase=pp.bb.start_phase)
            self._carries[i] = w[-187:].copy()
            padded.append(jnp.asarray(w))
            nbytes += w.size - 187
        out = self._step(padded if len(padded) > 1 else padded[0],
                         jnp.int32(self._frame_idx))
        self._frame_idx = (self._frame_idx
                           + self.plan.batch_frames) % self.cfg.t2_frames
        self._steps_done += 1
        self.counters.record_step(
            self.plan.batch_frames, self.plan.samples_out, nbytes,
            _time.perf_counter() - t0)
        return out

    def step_device(self, ts_bytes) -> jax.Array:
        """One step; returns the float32 (B, samples, 2) I/Q device array.

        ts_bytes: (bytes_per_step,) uint8 for single PLP, or a sequence of
        per-PLP arrays matching bytes_per_step_per_plp.
        """
        streams = (list(ts_bytes) if isinstance(ts_bytes, (list, tuple))
                   else [ts_bytes])
        assert len(streams) == len(self.plan.plps)
        windows = []
        for i, (pp, ts) in enumerate(zip(self.plan.plps, streams)):
            assert ts.shape == (pp.ts_bytes_in,), (ts.shape, pp.ts_bytes_in)
            windows.append(np.concatenate(
                [self._carries[i], np.asarray(ts, dtype=np.uint8)]))
        return self.step_window(windows if len(windows) > 1 else windows[0])

    def __call__(self, ts_bytes) -> np.ndarray:
        """Process one step of fresh TS bytes; returns complex64
        (B, samples_per_frame) on the host."""
        iq = np.asarray(self.step_device(ts_bytes))
        return iq.reshape(iq.shape[0], -1).view(np.complex64)

    # ----------------------------------------------------- checkpoint/resume
    def state_dict(self) -> dict:
        """The complete cross-step state (SURVEY.md sections 3.3/5.4): the
        187-byte carry window per PLP and the T2 frame counter."""
        return {
            "carries": np.stack(self._carries).copy(),
            "frame_idx": self._frame_idx,
            "steps_done": self._steps_done,
        }

    def load_state(self, state: dict) -> None:
        carries = np.asarray(state["carries"], dtype=np.uint8)
        assert carries.shape == (len(self.plan.plps), 187)
        self._carries = [carries[i].copy() for i in range(carries.shape[0])]
        self._frame_idx = int(state["frame_idx"]) % self.cfg.t2_frames
        # older checkpoints lack the step count; infer it so a legacy
        # checkpoint saved BEFORE any step (frame counter 0, all-zero
        # carries) is not refused its legitimate first step by
        # _check_streamable, while any post-step checkpoint counts as 1
        if "steps_done" in state:
            self._steps_done = int(state["steps_done"])
        else:
            fresh = (self._frame_idx == 0
                     and all(not c.any() for c in self._carries))
            self._steps_done = 0 if fresh else 1

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    def restore(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})

    def stream(self, ts_bytes) -> np.ndarray:
        """Like __call__ but returns the flat emitted sample stream, with
        FEF parts inserted after every fef_interval-th T2 frame (EN 302 755
        section 8.4; no-op when the config has no FEF)."""
        start = self._frame_idx  # global frame index before the step
        return self._with_fef(self(ts_bytes), start)

    def stream_window(self, windows) -> np.ndarray:
        """The pre-carried-window sibling of stream(): accepts step_window
        inputs (187-byte carry included, e.g. the native ingest ring's
        windows) and returns the flat emitted host stream incl. FEF parts."""
        start = self._frame_idx
        iq = np.asarray(self.step_window(windows))
        return self._with_fef(
            iq.reshape(iq.shape[0], -1).view(np.complex64), start)

    def _with_fef(self, frames: np.ndarray, start: int) -> np.ndarray:
        cfg = self.cfg
        if not cfg.has_fef:
            return frames.reshape(-1)
        parts = []
        for i in range(frames.shape[0]):
            parts.append(frames[i])
            if (start + i) % cfg.fef_interval == cfg.fef_interval - 1:
                parts.append(self.plan.fef_part)
        return np.concatenate(parts)
