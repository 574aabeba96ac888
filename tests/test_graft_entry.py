"""The driver entry points (__graft_entry__) must keep working: entry()
compiles both tails and cross-checks them (NaN-poison on disagreement),
dryrun_multichip asserts sharded == sequential."""
import sys

import jax
import numpy as np

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles_and_tails_agree():
    fn, args = graft.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.shape[0] == 2 and out.dtype == np.float32
    # the dual-tail cross-check inside fn poisons the output with NaNs on
    # planar/complex disagreement - finite output == tails agree
    assert np.isfinite(out).all()


def test_dryrun_multichip_small():
    # 2 devices: mux=2 x frame=1 plus the 2-device symbol-sharded leg;
    # raises AssertionError if any sharded output differs bit-for-bit
    # from the sequential chain
    graft.dryrun_multichip(2, devices=jax.devices("cpu"))
