"""chip_smoke.py on a machine without a GPU, and its golden comparison."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


@pytest.fixture(scope="module")
def golden():
    cfg, ts, bits, iq = chip_smoke.load_golden("vv009_4kshort")
    assert bits.shape[1] == cfg.ldpc_frame_bits
    assert iq.shape == (4, cfg.samples_per_frame)
    return bits, iq


def test_golden_check_accepts_the_golden(golden):
    bits, iq = golden
    assert chip_smoke.check_golden("g", bits, iq, bits, iq) == float("inf")


def test_golden_check_rejects_perturbed_iq(golden):
    bits, iq = golden
    noisy = iq.copy()
    noisy[1, ::97] += 1e-2 * np.abs(iq).max()   # well above -100 dB
    with pytest.raises(chip_smoke.SmokeFailure, match="dB"):
        chip_smoke.check_golden("g", bits, noisy, bits, iq)


def test_golden_check_rejects_a_flipped_fec_bit(golden):
    bits, iq = golden
    flipped = bits.copy()
    flipped[0, 12345] ^= 1
    with pytest.raises(chip_smoke.SmokeFailure, match="FEC"):
        chip_smoke.check_golden("g", flipped, iq, bits, iq)


def test_golden_check_rejects_nan_iq(golden):
    bits, iq = golden
    bad = iq.copy()
    bad[0, 0] = np.nan
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_golden("g", bits, bad, bits, iq)
