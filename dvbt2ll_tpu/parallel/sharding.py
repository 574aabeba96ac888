"""Multi-chip scaling (SURVEY.md sections 2.3 / 5.8).

The reference has no parallelism beyond GNU Radio's thread-per-block
pipeline.  This design shards over a device mesh instead:

  * ``mux``   - independent DVB-T2 channels (multi-mux scale-out, pure DP)
  * ``frame`` - T2 frames of one channel (DP with a 187-byte halo on the
                TS stream: the packet-CRC sync replacement looks back at
                most 187 bytes, so each shard gets an overlapping window
                and no cross-shard communication is needed at all)

Both axes are embarrassingly parallel through the entire chain, which is
the speed-of-light layout: zero collectives in steady state.  The only
sequential state of the reference (TS byte phase, CRC-8 carry, T2 frame
counter; SURVEY.md section 3.3) is resolved statically: the byte phase is
static per plan, the CRC carry is the halo, and the frame counter is an
arithmetic function of the step/shard index.

Symbol-axis (sequence-parallel) sharding of one giant frame is provided by
``grids_symbol_sharded`` for 32K single-frame latency work.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import T2Config
from ..pipeline import _consts, select_step_iq
from ..plan import TransmitPlan, build_plan


#: Inter-device ops in optimized HLO, sync AND async spellings: XLA
#: commonly splits collectives into -start/-done pairs, and point-to-point
#: traffic lowers to send/recv — an audit matching only the sync forms
#: would falsely report zero collectives.  Shared by
#: tests/test_sharding.py, tools/bench_scaling.py and chip_smoke.py so the
#: audits cannot drift.
import re as _re

#: The op name always follows its result shape, whose text ends in ']'
#: (array), '}' (layout) or ')' (tuple — send/recv and the async -start
#: forms return tuples, which contain spaces a \S* shape matcher misses).
_COLLECTIVE_PAT = _re.compile(
    r"[\])}]\s*((?:all-reduce|all-gather|collective-permute|all-to-all"
    r"|reduce-scatter|collective-broadcast|ragged-all-to-all)(?:-start"
    r"|-done)?|send|send-done|recv|recv-done)\(")


def find_collectives(hlo_text: str):
    """All inter-device op names found in optimized HLO text (empty list
    == the program is provably communication-free)."""
    return _COLLECTIVE_PAT.findall(hlo_text)


def _shard_map(fn, mesh, in_specs, out_specs, check=True):
    """jax.shard_map; ``check=False`` turns off the replication check."""
    kw = {} if check else {"check_vma": False}
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, **kw)


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              mux: int = 1, frame: Optional[int] = None) -> Mesh:
    """A (mux, frame) mesh over the given devices."""
    devices = list(devices if devices is not None else jax.devices())
    if frame is None:
        frame = len(devices) // mux
    assert mux * frame == len(devices), (mux, frame, len(devices))
    arr = np.array(devices).reshape(mux, frame)
    return Mesh(arr, ("mux", "frame"))


def halo_windows(ts_streams: np.ndarray, carries: np.ndarray,
                 n_shards: int) -> np.ndarray:
    """Split (C, bytes) fresh TS streams into overlapping per-shard windows.

    Returns (C, n_shards, 187 + bytes/n_shards) uint8.  carries is the
    (C, 187) tail from the previous step.
    """
    c, total = ts_streams.shape
    per = total // n_shards
    assert per * n_shards == total
    padded = np.concatenate([carries, ts_streams], axis=1)
    out = np.empty((c, n_shards, 187 + per), dtype=np.uint8)
    for s in range(n_shards):
        out[:, s] = padded[:, s * per : s * per + 187 + per]
    return out


class ShardedTransmitter:
    """N independent DVB-T2 muxes, frames sharded across a device mesh.

    Each device runs the full single-chain transmit step on its
    (mux-slice, frame-slice) block via shard_map; there is no cross-device
    traffic in the hot path.
    """

    def __init__(self, cfg: T2Config, mesh: Mesh, n_mux: int = 1,
                 frames_per_shard: Optional[int] = None,
                 strict: bool = True, allow_phase_drift: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.n_mux = n_mux
        mux_shards = mesh.shape["mux"]
        frame_shards = mesh.shape["frame"]
        if n_mux % mux_shards:
            raise ValueError("n_mux must divide over the mux axis")
        # each shard runs an independent plan instance of this many frames
        self.plan = build_plan(cfg, frames_per_shard, strict=strict)
        self._allow_phase_drift = allow_phase_drift
        if (frame_shards > 1 and not allow_phase_drift
                and not all(pp.bb.phase_invariant for pp in self.plan.plps)):
            # shard s>0's halo window starts s*per bytes into the stream;
            # unless per is a whole number of TS packets, that shard's
            # static phase-0 plan mislabels sync/CRC slots on the VERY
            # FIRST step - refuse rather than emit an invalid stream
            raise ValueError(
                "frame sharding needs a phase-invariant per-shard plan "
                "(per-shard TS payload a multiple of 188); use "
                "frames_per_shard=min_batch_frames(cfg), or pass "
                "allow_phase_drift=True to treat every shard window as an "
                "independent phase-0 stream (NOT a valid continuous "
                "DVB-T2 stream)")
        # the SAME tail decision as the single-device Transmitter on this
        # platform (shared helper keeps the sharded == sequential
        # bit-identity invariant)
        step_iq, self._planar_tail = select_step_iq(
            cfg, np.asarray(mesh.devices).flat[0].platform)
        self.frame_shards = frame_shards
        self.mux_per_shard = n_mux // mux_shards
        self.frames_per_step = self.plan.batch_frames * frame_shards
        n_plp = len(self.plan.plps)
        self._carries = np.zeros((n_mux, n_plp, 187), dtype=np.uint8)
        self._step_no = 0
        _consts(self.plan)

        plan = self.plan
        t2 = cfg.t2_frames

        def shard_fn(*args):
            # per-PLP windows (mux_per_shard, 1 frame-shard slice, bytes_p)
            # + frame_idx0; inside shard_map each device sees its local block
            *windows, frame_idx0 = args

            def one_mux(ws, fi):
                return step_iq(
                    plan, list(ws) if len(ws) > 1 else ws[0], fi)

            locals_ = tuple(w[:, 0] for w in windows)
            return jax.vmap(one_mux)(locals_, frame_idx0[:, 0])[:, None]

        # check=False: the map is embarrassingly parallel (no collectives)
        self._in_specs = tuple([P("mux", "frame", None)] * n_plp
                               + [P("mux", "frame")])
        self._sharded = jax.jit(_shard_map(
            shard_fn, mesh=mesh,
            in_specs=self._in_specs,
            out_specs=P("mux", "frame", None, None, None),
            check=False,
        ))

    def step_device(self, ts_bytes) -> jax.Array:
        """ts_bytes: (n_mux, frames_per_step * df_bytes * fec_blocks) fresh
        bytes per mux for a single-PLP chain, or a sequence of such arrays
        (one per PLP, sized n_mux x bytes_per_step_per_mux_per_plp[i]).
        Returns float32 (n_mux, frame_shards, B_local, samples, 2)."""
        cfg = self.cfg
        if (self._step_no and not self._allow_phase_drift
                and not all(pp.bb.phase_invariant
                            for pp in self.plan.plps)):
            raise RuntimeError(
                "this plan is single-shot: its per-shard step payload is "
                "not a multiple of the TS packet length, so a second step "
                "would start at a drifted packet phase; build with "
                "frames_per_shard=min_batch_frames(cfg) for streaming, or "
                "pass allow_phase_drift=True for mechanism tests/benches")
        streams = (list(ts_bytes) if isinstance(ts_bytes, (list, tuple))
                   else [ts_bytes])
        assert len(streams) == len(self.plan.plps)
        windows = []
        for i, (pp, s) in enumerate(zip(self.plan.plps, streams)):
            s = np.asarray(s, dtype=np.uint8)
            assert s.shape == (self.n_mux,
                               pp.ts_bytes_in * self.frame_shards), s.shape
            w = halo_windows(s, self._carries[:, i], self.frame_shards)
            windows.append(self._mesh_put(w, self._in_specs[i]))
            self._carries[:, i] = s[:, -187:]
        # T2 frame index of the first frame of each shard; keep the step
        # counter bounded so the int32 device cast can never wrap (the
        # counter advances by frames_per_step each step, so only its value
        # mod t2_frames matters)
        self._step_no %= cfg.t2_frames
        base = self._step_no * self.frames_per_step
        fidx = (base + np.arange(self.frame_shards) * self.plan.batch_frames
                ) % cfg.t2_frames
        fidx = np.broadcast_to(fidx[None], (self.n_mux, self.frame_shards))
        self._step_no += 1
        return self._sharded(
            *windows, self._mesh_put(fidx.astype(np.int32), self._in_specs[-1]))

    def _mesh_put(self, arr: np.ndarray, spec) -> jax.Array:
        """Host numpy -> device array laid out for the mesh: each device
        receives only its own block.

        Multi-process (jax.distributed, SURVEY.md section 5.8): every host
        holds the full input; make_array_from_callback materializes only
        this process's addressable shards, so the global array is
        assembled without any cross-host transfer.  The hot path itself
        stays collective-free either way."""
        sharding = NamedSharding(self.mesh, spec)
        if jax.process_count() > 1:
            return jax.make_array_from_callback(
                arr.shape, sharding, lambda idx: arr[idx])
        return jax.device_put(arr, sharding)

    def __call__(self, ts_bytes: np.ndarray) -> np.ndarray:
        """Returns complex64 (n_mux, frames_per_step, samples_per_frame)."""
        iq = np.asarray(self.step_device(ts_bytes))
        c = iq.shape[0]
        return iq.reshape(c, self.frames_per_step, -1).view(np.complex64)

    def stream(self, ts_bytes) -> np.ndarray:
        """Like __call__ but returns the flat (n_mux, samples) emitted
        stream with FEF parts inserted after every fef_interval-th T2 frame
        (EN 302 755 section 8.4; no-op when the config has no FEF).  The
        frame counter is bounded mod t2_frames, which preserves the FEF
        cadence because fef_interval divides t2_frames (validated)."""
        start = (self._step_no % self.cfg.t2_frames) * self.frames_per_step
        frames = self(ts_bytes)
        if not self.cfg.has_fef:
            return frames.reshape(frames.shape[0], -1)
        iv = self.cfg.fef_interval
        out = []
        for c in range(frames.shape[0]):
            parts = []
            for i in range(frames.shape[1]):
                parts.append(frames[c, i])
                if (start + i) % iv == iv - 1:
                    parts.append(self.plan.fef_part)
            out.append(np.concatenate(parts))
        return np.stack(out)

    @property
    def bytes_per_step_per_mux(self) -> int:
        return self.plan.ts_bytes_in * self.frame_shards

    @property
    def bytes_per_step_per_mux_per_plp(self) -> tuple:
        return tuple(pp.ts_bytes_in * self.frame_shards
                     for pp in self.plan.plps)

    # ----------------------------------------------------- checkpoint/resume
    def state_dict(self) -> dict:
        """Cross-step state: the per-mux/per-PLP TS carry windows and the
        step counter (the T2 frame index is derived from it)."""
        return {"carries": self._carries.copy(), "step_no": self._step_no}

    def load_state(self, state: dict) -> None:
        carries = np.asarray(state["carries"], dtype=np.uint8)
        assert carries.shape == self._carries.shape, (
            carries.shape, self._carries.shape)
        self._carries = carries.copy()
        self._step_no = int(state["step_no"])

    def save(self, path: str) -> None:
        """File-checkpoint helpers mirroring Transmitter.save/restore
        (the two FORMATS differ: sharded carries are (mux, plp, 187))."""
        np.savez(path, **self.state_dict())

    def restore(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})


def grids_symbol_sharded(plan: TransmitPlan, mesh: Mesh, axis: str = "frame"):
    """Sequence-parallel OFDM back-end: shard the (B, S, fft) grids over the
    symbol axis for the batched IFFT + guard-interval stage - for very large
    FFT sizes where a single frame's IFFTs dominate latency.  The symbol axis
    is zero-padded to the shard count and each device IFFTs its contiguous
    slab (explicit shard_map: XLA's CPU fft thunk rejects the padded layouts
    GSPMD produces for non-divisible shardings).  Returns a jitted fn."""
    from ..pipeline import (_as_windows, bb_and_fec, build_frames, map_cells)

    cfg = plan.cfg
    _consts(plan)
    n = mesh.shape[axis]
    fft, gi, s = cfg.fft_points, cfg.guard_samples, cfg.num_symbols
    scale = np.complex64(fft * cfg.ofdm_normalization)

    eq = _consts(plan)["eq"]

    def local_ifft_gi(g):  # (B, S_pad/n, fft) on one device
        if eq is not None:
            g = g * eq
        t = (jnp.fft.ifft(g, axis=-1) * scale).astype(jnp.complex64)
        return jnp.concatenate([t[..., fft - gi:], t], axis=-1)

    spec = {"mux": P(None, axis, None), "frame": P(None, axis, None)}[axis]
    sharded_ifft = _shard_map(local_ifft_gi, mesh=mesh,
                              in_specs=spec, out_specs=spec)

    def fn(ts_padded, frame_idx0):
        payloads = []
        for pp, w in zip(plan.plps, _as_windows(plan, ts_padded)):
            cells = map_cells(pp, bb_and_fec(pp, w))
            payloads.append(cells.reshape(plan.batch_frames,
                                          pp.cfg.stream_cells))
        payload = (payloads[0] if len(payloads) == 1
                   else jnp.concatenate(payloads, axis=1))
        grids = build_frames(plan, payload, frame_idx0)
        b = grids.shape[0]
        pad = (-s) % n
        g = jnp.pad(grids, ((0, 0), (0, pad), (0, 0)))
        t = sharded_ifft(g)[:, :s]
        body = t.reshape(b, s * (fft + gi))
        c = _consts(plan)
        p1 = jnp.tile(jnp.asarray(c["p1"])[None, :], (b, 1))
        out = jnp.concatenate([p1, body], axis=1)
        return jnp.stack([jnp.real(out), jnp.imag(out)], axis=-1)

    return jax.jit(fn)
