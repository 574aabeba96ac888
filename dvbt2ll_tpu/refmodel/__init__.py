"""Sequential numpy oracle of the DVB-T2 transmit chain.

This package mirrors the *algorithms* of the reference implementation
(gr-dvbt2ll) stage by stage with plain loops, exactly as the C++ hot loops
execute them, and serves as the golden model for testing the composed
jitted plan.  It is deliberately slow and simple.
"""
from .chain import (bbheader_frames, interleave_and_map, ldpc_encode,
                    frame_map, ofdm_modulate, transmit_chain)

__all__ = ["bbheader_frames", "ldpc_encode", "interleave_and_map",
           "frame_map", "ofdm_modulate", "transmit_chain"]
