"""Planar f32 4-step IFFT + guard interval, as XLA einsums.

The OFDM tail without complex64: the Bailey 4-step IFFT runs as matrix
products on separate real/imag f32 planes and writes the guard-interval
prefix + body directly.  Match: the reference's per-symbol FFTW execute
+ 2-memcpy cyclic prefix (lib/pilotgenp1insert_cc_impl.cc:2890-2897).

Layout trick that makes it transpose-free: with N = N1*N2 (N1 = 128)
and the decimation n = n1 + N1*n2, k = N2*k1 + k2,

    x[n1 + N1*n2] = (1/N) sum_k2 W2[n2,k2] * T[k2,n1]
                    * sum_k1 At[k2,k1] W1[k1,n1]

where At[k2,k1] = X[N2*k1 + k2] is the TRANSPOSED-GRID layout the frame
builder's gather can emit for free (grid_src is an arbitrary
permutation).  Both products then keep n1 on the minor axis, the result
rows (n2) are already in natural sample order, and the cyclic prefix is
a whole-row concat: out rows = [last gi/N1 rows | all rows].  Agrees
with np.fft.ifft to >120 dB in f32 with Precision.HIGHEST products
(tests/test_planar_tail.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

N1 = 128  # length of the second DFT factor (the minor axis)


def supported(fft: int, gi: int) -> bool:
    """Geometry gate for the planar tail: the whole-row guard interval
    needs fft and gi to be multiples of 128, and n2 = fft/128 is held to
    8..64 (1K-8K), where the 4-step's N*(N2+128) multiply-adds per sample
    stay small.  Outside the gate the chain keeps the complex tail."""
    return fft % N1 == 0 and gi % N1 == 0 and 8 <= fft // N1 <= 64


def factor_matrices(fft: int, scale: float):
    """(w1r, w1i, ttr, tti, w2r, w2i) f32 host constants; `scale` (the
    1/N of the inverse transform times the chain's fft*ofdm_norm) is
    folded into W1."""
    n2 = fft // N1
    k1 = np.arange(N1)
    k2 = np.arange(n2)
    w1 = np.exp(2j * np.pi * np.outer(k1, k1) / N1) * scale
    t = np.exp(2j * np.pi * np.outer(k2, k1) / fft)    # T[k2, n1]
    w2 = np.exp(2j * np.pi * np.outer(k2, k2) / n2)
    return (np.float32(w1.real), np.float32(w1.imag),
            np.float32(t.real), np.float32(t.imag),
            np.float32(w2.real), np.float32(w2.imag))


def ifft_gi_einsum(grids_re_t: jnp.ndarray, grids_im_t: jnp.ndarray,
                   fft: int, gi: int, scale: float):
    """Transposed-layout grids (B, S, N2, N1) f32 planes -> GI'd time
    domain (B, S, fft + gi) f32 planes (re, im).

    Input element [b, s, k2, k1] must hold carrier bin N2*k1 + k2 of
    symbol s (the frame builder emits this directly by permuting its
    gather map).  Stage 1 contracts over the 128-wide axis with
    M = B*S*N2, stage 2 is one small-by-wide product.  Precision.HIGHEST
    is load-bearing: lower-precision products fail the 100 dB check."""
    hi = jax.lax.Precision.HIGHEST
    b, s, n2, n1 = grids_re_t.shape
    assert n1 == N1 and n2 == fft // N1 and gi % N1 == 0
    gi_rows = gi // N1
    w1r, w1i, ttr, tti, w2r, w2i = factor_matrices(fft, scale)
    br = (jnp.einsum("xskn,nm->xskm", grids_re_t, w1r, precision=hi)
          - jnp.einsum("xskn,nm->xskm", grids_im_t, w1i, precision=hi))
    bi = (jnp.einsum("xskn,nm->xskm", grids_re_t, w1i, precision=hi)
          + jnp.einsum("xskn,nm->xskm", grids_im_t, w1r, precision=hi))
    cr = br * ttr - bi * tti
    ci = br * tti + bi * ttr
    xr = (jnp.einsum("ab,xsbn->xsan", w2r, cr, precision=hi)
          - jnp.einsum("ab,xsbn->xsan", w2i, ci, precision=hi))
    xi = (jnp.einsum("ab,xsbn->xsan", w2r, ci, precision=hi)
          + jnp.einsum("ab,xsbn->xsan", w2i, cr, precision=hi))
    body_re = jnp.concatenate([xr[:, :, n2 - gi_rows:], xr], axis=2)
    body_im = jnp.concatenate([xi[:, :, n2 - gi_rows:], xi], axis=2)
    return (body_re.reshape(b, s, fft + gi),
            body_im.reshape(b, s, fft + gi))
