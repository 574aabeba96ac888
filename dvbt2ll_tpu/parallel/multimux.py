"""Heterogeneous multi-mux scale-out: N independent DVB-T2 channels with
PER-CHANNEL configs on one device pool.

The reference analog is "N independent flowgraphs" (SURVEY.md section 2.3
/ BASELINE config 5: 8+ independent DVB-T2 channels).  Channels with
different modes have different tensor shapes, so one shard_map cannot
cover them; the composition is a SUBMESH per channel group: the device pool is partitioned, each group gets its own
(mux, frame) mesh and ShardedTransmitter, and the groups' XLA programs
run concurrently because they touch disjoint devices and dispatch is
asynchronous (step enqueues every group before any drain).  Channels
that DO share a config can share one group (n_mux > 1) and keep the
single-program efficiency of ShardedTransmitter.

The hot path stays collective-free: there is no cross-channel
communication of any kind, matching the reference's fully independent
flowgraphs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import jax
import numpy as np

from ..config import T2Config
from .sharding import ShardedTransmitter, make_mesh


@dataclass
class MuxChannel:
    """One channel group: ``n_mux`` independent muxes sharing ``cfg``.

    ``n_devices`` pins the group's share of the device pool (must be a
    multiple of ``n_mux``); None = an equal share of the remainder.
    ``frames_per_shard`` / ``allow_phase_drift`` / ``strict`` follow
    ShardedTransmitter semantics per group.
    """
    cfg: T2Config
    n_mux: int = 1
    n_devices: Optional[int] = None
    frames_per_shard: Optional[int] = None
    strict: bool = True
    allow_phase_drift: bool = False


class MultiMuxTransmitter:
    """Independent DVB-T2 channels with heterogeneous configs.

    ``channels``: MuxChannel specs (or bare T2Configs, treated as
    single-mux groups).  ``devices``: the pool to partition (default
    ``jax.devices()``).  Devices are assigned to groups in order.
    """

    def __init__(self, channels: Sequence, devices=None):
        import dataclasses

        devices = list(devices if devices is not None else jax.devices())
        # own copies: the pool split assigns n_devices in place, and a
        # caller may legitimately reuse one MuxChannel spec object
        self.channels: List[MuxChannel] = [
            dataclasses.replace(c) if isinstance(c, MuxChannel)
            else MuxChannel(cfg=c) for c in channels]
        if not self.channels:
            raise ValueError("need at least one channel")

        # partition the pool: pinned groups first, equal split of the rest
        for c in self.channels:
            if c.n_devices is not None and c.n_devices < 1:
                raise ValueError("channel n_devices must be >= 1 when set")
        pinned = sum(c.n_devices or 0 for c in self.channels)
        floating = [c for c in self.channels if c.n_devices is None]
        if pinned > len(devices):
            raise ValueError(
                f"channel n_devices sum to {pinned} > pool {len(devices)}")
        if floating:
            rest = len(devices) - pinned
            share, odd = divmod(rest, len(floating))
            if share < 1 or odd:
                raise ValueError(
                    f"{rest} unpinned devices do not split evenly over "
                    f"{len(floating)} channels; pin n_devices per channel")
            for c in floating:
                c.n_devices = share
        elif pinned != len(devices):
            # all channels pinned but devices left over: loud, like the
            # uneven-split path (pass a sliced pool to use fewer devices)
            raise ValueError(
                f"channel n_devices sum to {pinned} but the pool has "
                f"{len(devices)} devices; slice the pool or adjust pins")
        for c in self.channels:
            if c.n_devices % c.n_mux:
                raise ValueError(
                    f"channel n_devices={c.n_devices} must be a multiple "
                    f"of n_mux={c.n_mux}")

        self.transmitters: List[ShardedTransmitter] = []
        self.meshes = []
        pos = 0
        for c in self.channels:
            group = devices[pos : pos + c.n_devices]
            pos += c.n_devices
            mesh = make_mesh(group, mux=c.n_mux)
            self.meshes.append(mesh)
            self.transmitters.append(ShardedTransmitter(
                c.cfg, mesh, n_mux=c.n_mux,
                frames_per_shard=c.frames_per_shard, strict=c.strict,
                allow_phase_drift=c.allow_phase_drift))

    @property
    def bytes_per_step(self) -> list:
        """Per-channel fresh-TS bytes per step: for each channel either an
        int (single PLP) or a tuple (per PLP), per mux."""
        out = []
        for stx in self.transmitters:
            per = stx.bytes_per_step_per_mux_per_plp
            out.append(per[0] if len(per) == 1 else per)
        return out

    def step_device(self, ts_per_channel: Sequence) -> list:
        """One step of every channel.  ``ts_per_channel[i]`` follows
        ShardedTransmitter.step_device for channel i ((n_mux, bytes) or a
        per-PLP sequence).  All groups are ENQUEUED before any result is
        touched, so disjoint-device programs overlap; returns the list of
        per-channel device arrays."""
        assert len(ts_per_channel) == len(self.transmitters)
        return [stx.step_device(ts)
                for stx, ts in zip(self.transmitters, ts_per_channel)]

    def __call__(self, ts_per_channel: Sequence) -> list:
        """Per-channel complex64 (n_mux, frames_per_step, samples)."""
        outs = self.step_device(ts_per_channel)
        res = []
        for stx, o in zip(self.transmitters, outs):
            iq = np.asarray(o)
            res.append(iq.reshape(iq.shape[0], stx.frames_per_step, -1)
                       .view(np.complex64))
        return res

    # ----------------------------------------------------- checkpoint/resume
    def state_dict(self) -> dict:
        return {f"ch{i}_{k}": v
                for i, stx in enumerate(self.transmitters)
                for k, v in stx.state_dict().items()}

    def load_state(self, state: dict) -> None:
        # split generically by prefix so fields ShardedTransmitter adds
        # later round-trip without touching this class
        for i, stx in enumerate(self.transmitters):
            prefix = f"ch{i}_"
            stx.load_state({k[len(prefix):]: v for k, v in state.items()
                            if k.startswith(prefix)})

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    def restore(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})
