"""Generate ground-truth golden vectors from the REFERENCE C++ itself.

Builds native/refshim/ref_harness (the unmodified reference sources from
$REFERENCE_DIR/lib compiled against stub GR headers), drives all four
reference blocks plus the reference's own LDPC encoder end-to-end on a
deterministic synthetic TS stream, and packages every stage boundary into
tests/golden_ref/<name>.npz.

This breaks the circularity of testing against the repo's own oracle:
these vectors share NO code with dvbt2ll_tpu/ — they come from the
reference binary.

Usage: python tools/gen_reference_golden.py [name ...]
       (default: all three BASELINE configs)
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_DIR = os.environ.get("REFERENCE_DIR", "/root/reference")
HARNESS = os.path.join(REPO, "native", "refshim", "ref_harness")
OUT_DIR = os.path.join(REPO, "tests", "golden_ref")

TS_SEED = 1234  # fixed: the npz records the stream, tests regenerate it

# T2 frames to capture per config: vv009 gets 2 superframes (covers the
# t2_frames wrap of the L1-post frame counter), the big configs get one.
# The second row is the mode/MISO matrix: each entry pins a reference
# work-loop branch the BASELINE trio never takes (hieff_2k needs 17
# frames so the HIEFF payload is a whole number of 187-byte packets).
N_FRAMES = {"vv009_4kshort": 4, "8k_normal": 2, "32k_extended": 2,
            "hieff_4k": 17, "inband_2k": 2,
            "8k_miso_tx1": 2, "8k_miso_tx2": 2, "32k_papr_tr": 2,
            "16k_l1qpsk_both": 2, "1k_pp4": 2,
            "qpsk_short_c13": 2, "ti_off_4k": 2,
            "t2lite_4k": 2, "t2lite_8k_t2gi_miso": 2, "v121_4k": 2,
            "t2lite_16k_t2gi": 2, "eq_2k_5mhz": 2}


def build_harness() -> str:
    if not os.path.isdir(REFERENCE_DIR):
        raise FileNotFoundError(f"reference tree not found: {REFERENCE_DIR}")
    subprocess.run(
        ["make", "-C", os.path.join(REPO, "native"), "refshim/ref_harness"],
        check=True, env={**os.environ, "REFERENCE_DIR": REFERENCE_DIR})
    return HARNESS


def harness_args(cfg, nframes: int, tsfile: str, outdir: str):
    """T2Config -> reference make() arguments (enum values are identical
    by construction, tests/test_config.py checks them against
    include/dvbt2ll/dvbt2ll_config.h)."""
    return [
        f"framesize={int(cfg.frame_size)}",
        f"rate={int(cfg.code_rate)}",
        f"constellation={int(cfg.constellation)}",
        f"rotation={int(cfg.rotation)}",
        f"fftsize={int(cfg.fft_size)}",
        f"guardinterval={int(cfg.guard_interval)}",
        f"pilotpattern={int(cfg.pilot_pattern)}",
        f"carriermode={int(cfg.carrier_mode)}",
        f"preamble={int(cfg.preamble)}",
        f"misogroup={int(cfg.miso_group)}",
        f"papr={int(cfg.papr)}",
        f"version={int(cfg.version)}",
        f"l1constellation={int(cfg.l1_constellation)}",
        f"l1scrambled={int(bool(cfg.l1_scrambled))}",
        f"reservedbiasbits={int(bool(cfg.reserved_bias_bits))}",
        f"fecblocks={cfg.fec_blocks}",
        f"tiblocks={cfg.ti_blocks}",
        f"t2frames={cfg.t2_frames}",
        f"numdatasyms={cfg.num_data_symbols}",
        f"inputmode={int(cfg.input_mode)}",
        f"inband={int(cfg.in_band)}",
        f"tsrate={cfg.ts_rate}",
        f"bandwidth={int(cfg.bandwidth)}",
        f"equalization={int(bool(cfg.equalization))}",
        f"vlength={cfg.fft_points}",
        f"nframes={nframes}",
        f"tsfile={tsfile}",
        f"outdir={outdir}",
    ]


def generate(name: str, cfg=None) -> str:
    from bench import _named_config
    from dvbt2ll_tpu.io import synthetic_ts

    if cfg is None:
        cfg = _named_config(name)
    nframes = N_FRAMES.get(name, 2)
    fecframes = nframes * cfg.fec_blocks
    # input bytes the reference consumes for fecframes frames: payload
    # (minus 13/group for in-band) plus the dropped sync bytes in HIEFF
    from dvbt2ll_tpu.tables.bbframe import BBFramePlan
    ts_bytes = BBFramePlan(cfg, fecframes, strict=False).ts_bytes_in
    ts = synthetic_ts(ts_bytes, seed=TS_SEED)

    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        tsfile = os.path.join(tmp, "input.ts")
        ts.tofile(tsfile)
        subprocess.run([HARNESS] + harness_args(cfg, nframes, tsfile, tmp),
                       check=True)

        meta = {}
        with open(os.path.join(tmp, "meta.txt")) as f:
            for line in f:
                k, v = line.strip().split("=")
                meta[k] = int(v)

        def raw(fname, dtype):
            return np.fromfile(os.path.join(tmp, fname), dtype=dtype)

        bits1 = raw("stage1_bbbch.u8", np.uint8)
        bits2 = raw("stage2_ldpc.u8", np.uint8)
        cells3 = raw("stage3_cells.c64", np.complex64)
        frames4 = raw("stage4_frames.c64", np.complex64)
        iq5 = raw("stage5_iq.c64", np.complex64)

    # cross-check the reference-derived counts against our T2Config
    assert meta["nbch"] == cfg.nbch, (meta["nbch"], cfg.nbch)
    assert meta["kbch"] == cfg.kbch
    assert meta["frame_bits"] == cfg.ldpc_frame_bits
    assert meta["cell_size"] == cfg.cell_size
    assert meta["mapped_items"] == cfg.mapped_cells, (
        meta["mapped_items"], cfg.mapped_cells)
    assert meta["samples"] == cfg.samples_per_frame
    assert bits1.size == fecframes * cfg.nbch
    assert iq5.size == nframes * cfg.samples_per_frame

    path = os.path.join(OUT_DIR, f"{name}.npz")
    np.savez_compressed(
        path,
        name=name, ts_seed=TS_SEED, ts_bytes=ts_bytes, nframes=nframes,
        # bits packed 8x: unpack with np.unpackbits(...)[:count]
        stage1_bits_packed=np.packbits(bits1), stage1_count=bits1.size,
        stage2_bits_packed=np.packbits(bits2), stage2_count=bits2.size,
        stage3_cells=cells3, stage4_frames=frames4, stage5_iq=iq5)
    print(f"{name}: wrote {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, {nframes} T2 frames)")
    return path


def main():
    names = sys.argv[1:] or list(N_FRAMES)
    build_harness()
    for name in names:
        generate(name)


if __name__ == "__main__":
    main()
