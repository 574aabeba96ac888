"""dvbt2ll_tpu: a DVB-T2 (EN 302 755) transmit framework in JAX.

A from-scratch JAX/XLA implementation with the capabilities of the
gr-dvbt2ll GNU Radio module (plus the in-tree LDPC encoder its example
flowgraph depends on), redesigned for an accelerator: the whole chain
compiles to a handful of gathers, GF(2) matmuls and batched IFFTs over
batches of T2 frames, sharded across devices with jax.sharding.
"""
from .config import (Bandwidth, CarrierMode, CodeRate, Constellation, FFTSize,
                     FrameSize, GuardInterval, InBand, InputMode,
                     L1Constellation, MisoGroup, PAPR, PilotPattern, Preamble,
                     PLPConfig, Rotation, T2Config, Version, vv009_config)
from .pipeline import Transmitter, transmit_step
from .plan import TransmitPlan, build_plan, min_batch_frames

__version__ = "0.1.0"

__all__ = [
    "T2Config", "PLPConfig", "vv009_config", "Transmitter", "TransmitPlan", "build_plan",
    "transmit_step", "min_batch_frames",
    "Bandwidth", "CarrierMode", "CodeRate", "Constellation", "FFTSize",
    "FrameSize", "GuardInterval", "InBand", "InputMode", "L1Constellation",
    "MisoGroup", "PAPR", "PilotPattern", "Preamble", "Rotation", "Version",
]
