"""Pipelined streaming executor: ingest -> device -> sink with overlap.

The reference gets pipeline parallelism for free from GNU Radio's
thread-per-block scheduler (SURVEY.md section 2.3).  Here the same
overlap comes from XLA's asynchronous dispatch: step N is enqueued on
the device while step N-1's IQ is still being fetched and written to the
sink, with the (cheap) host work of TS framing interleaved between.

    executor = StreamingExecutor(tx, source=ingest_or_callable, sink=sink)
    executor.run(n_steps)           # or run_forever() until EOF
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Union

import numpy as np

from .pipeline import Transmitter


class StreamingExecutor:
    """Double-buffered transmit loop.

    source: a callable ``(n_bytes) -> np.ndarray`` per PLP stream (or a
        list of callables for multi-PLP), e.g. ``TSFileSource.read``, a
        ``TSIngest`` window closure, or ``synthetic_ts``-style generator.
    sink: an object with ``write(iq: np.ndarray)`` (e.g. IQFileSink), or
        None to drop output on the floor (benchmarking).
    """

    def __init__(self, tx: Transmitter, source, sink=None,
                 realtime: bool = False):
        self.tx = tx
        self.sources = source if isinstance(source, (list, tuple)) else [source]
        assert len(self.sources) == len(tx.plan.plps)
        self.sink = sink
        self.realtime = realtime
        self._pending = None  # (device array, start frame idx) of prev step

    def _read_step_input(self):
        return [np.asarray(src(pp.ts_bytes_in), dtype=np.uint8)
                for src, pp in zip(self.sources, self.tx.plan.plps)]

    def _drain(self) -> Optional[np.ndarray]:
        if self._pending is None:
            return None
        dev, start = self._pending
        iq = np.asarray(dev)  # device->host of step N-1
        self._pending = None
        frames = iq.reshape(iq.shape[0], -1).view(np.complex64)
        if self.tx.cfg.has_fef:
            # the emitted stream carries FEF parts (like Transmitter.stream)
            return self.tx._with_fef(frames, start)[None]
        return frames

    def step(self) -> Optional[np.ndarray]:
        """Enqueue one device step, return the PREVIOUS step's IQ (None on
        the first call) - the overlap window."""
        streams = self._read_step_input()
        ts = streams if len(streams) > 1 else streams[0]
        # enqueue step N BEFORE draining step N-1: XLA dispatch is async,
        # so the blocking device->host fetch of N-1 overlaps with N's
        # compute instead of leaving the device idle.
        start = self.tx._frame_idx  # frame index this step starts at
        try:
            pending = self.tx.step_device(ts)
        except Exception:
            # don't lose the already-computed step N-1 held in _pending
            self.flush()
            raise
        prev = self._drain()
        self._pending = (pending, start)
        if prev is not None and self.sink is not None:
            self.sink.write(prev)
        return prev

    def flush(self) -> Optional[np.ndarray]:
        prev = self._drain()
        if prev is not None and self.sink is not None:
            self.sink.write(prev)
        return prev

    def run(self, n_steps: int) -> dict:
        """Run n_steps with overlap; returns the transmitter counters.

        realtime=True paces at the AIR rate of what is actually emitted:
        for FEF configs each step's airtime includes the FEF parts the
        drain inserts (fef_interval divides t2_frames by validate(), so
        the per-step average is exact over a superframe)."""
        t0 = time.perf_counter()
        deadline = t0
        frame_t = (self.tx.plan.batch_frames
                   * self.tx.cfg.emitted_frame_duration)
        for _ in range(n_steps):
            self.step()
            if self.realtime:
                deadline += frame_t
                now = time.perf_counter()
                if deadline > now:
                    time.sleep(deadline - now)
        self.flush()
        wall = time.perf_counter() - t0
        stats = self.tx.counters.as_dict()
        stats["wall_clock_seconds"] = wall
        stats["sustained_samples_per_second"] = (
            self.tx.counters.samples / wall)
        return stats
