"""Speed-of-light (roofline) model of the transmit chain on one device.

Counts the UNAVOIDABLE device-memory traffic of each pipeline stage -
every array a stage must materialize because the next op is a
gather/FFT/reshape that cannot fuse through it - and converts it to a
samples/s ceiling at the device's memory bandwidth.  Also accounts the
IFFT FLOPs against the f32 compute peak to show which bound binds.  Pure
host arithmetic: the peaks come from PEAKS, keyed by device kind.

Usage: python tools/roofline.py [--kind DEVICE_KIND] [batch] [config ...]
  --kind: a key of PEAKS (default: jax.devices()[0].device_kind)
"""
import sys

from _common import jax

from bench import _named_config
from dvbt2ll_tpu.plan import build_plan

#: device_kind -> (memory bytes/s, f32 FLOP/s outside the tensor cores),
#: dense published peaks at the full power limit.  Source: NVIDIA H100
#: Tensor Core GPU data sheet (SXM5: 3.35 TB/s HBM3, 67 TFLOP/s FP32).
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}


def peaks(kind: str):
    """(bytes/s, f32 FLOP/s) of a device kind; an unknown kind is an
    error - no peak is assumed."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def stage_traffic(cfg, plan, batch):
    """[(stage, bytes, note)] of unavoidable memory reads+writes per step."""
    f = plan.fec_frames
    pp = plan.plps[0]
    samples = batch * cfg.samples_per_frame
    bits = f * cfg.ldpc_frame_bits          # u8 bit-planes
    cells = f * cfg.cell_size * 8           # complex64
    grid = batch * cfg.num_symbols * cfg.fft_points * 8
    out = samples * 8                       # c64 (== f32 I/Q planes)

    t = []
    t.append(("bb+BCH+LDPC", pp.ts_bytes_in            # read TS bytes
              + f * cfg.nbch                           # stream bits materialized
                                                       # once (gather-free front
                                                       # end fuses the rest)
              + bits,                                  # write frame bits
              "in: TS u8; out: (F, frame_bits) u8"))
    t.append(("bit-ilv + QAM map", bits                # gather read
              + cells,                                 # write cells
              "gather src + c64 cells"))
    t.append(("frame build (1 gather)", cells          # gather read
              + grid,                                  # write grids (+pilots
                                                       # fused)
              "grid_src gather + pilot add"))
    t.append(("IFFT", 2 * grid,                        # read+write (in-place
                                                       # FFT still streams both
                                                       # ways)
              "per-symbol c64 FFT"))
    t.append(("GI + P1 + IQ out", grid + out,          # read time domain, write
                                                       # final stream
              "cyclic-prefix concat + f32 planes"))
    return t, samples


def main():
    argv = sys.argv[1:]
    if argv[:1] == ["--kind"]:
        kind, argv = argv[1], argv[2:]
    else:
        kind = jax.devices()[0].device_kind
    mem_bps, f32_flops = peaks(kind)
    batch = int(argv[0]) if argv else 256
    names = argv[1:] or ["vv009_4kshort", "8k_normal", "32k_extended"]
    print(f"{kind}: {mem_bps / 1e12:.2f} TB/s, "
          f"{f32_flops / 1e12:.0f} TFLOP/s f32")
    for name in names:
        cfg = _named_config(name)
        # the cells' batches: 256 for the 4K/8K class, 128 at 32K
        b = batch if cfg.fft_points <= 8192 else min(batch, 128)
        plan = build_plan(cfg, b, strict=False)
        rows, samples = stage_traffic(cfg, plan, b)
        total = sum(r[1] for r in rows)
        # IFFT compute: 5 N log2 N real FLOPs per c64 transform
        import math
        n = cfg.fft_points
        fft_flops = 5 * n * math.log2(n) * b * cfg.num_symbols
        fft_t_bw = 2 * b * cfg.num_symbols * n * 8 / mem_bps
        fft_t_fl = fft_flops / f32_flops
        print(f"\n== {name} (batch {b}, {samples/1e6:.2f} Msamples/step) ==")
        for stage, byt, note in rows:
            t_us = byt / mem_bps * 1e6
            print(f"  {stage:24s} {byt/1e6:9.2f} MB  {t_us:8.1f} us   {note}")
        sol = samples / (total / mem_bps)
        print(f"  {'TOTAL':24s} {total/1e6:9.2f} MB  "
              f"{total/mem_bps*1e6:8.1f} us")
        print(f"  IFFT bound: bandwidth {fft_t_bw*1e6:.1f} us vs compute "
              f"{fft_t_fl*1e6:.1f} us ({fft_flops/1e9:.2f} GFLOP) -> "
              f"{'BANDWIDTH' if fft_t_bw > fft_t_fl else 'COMPUTE'}-bound")
        print(f"  speed-of-light: {sol/1e6:,.0f} Msamples/s/device "
              f"at {mem_bps/1e9:.0f} GB/s")


if __name__ == "__main__":
    main()
