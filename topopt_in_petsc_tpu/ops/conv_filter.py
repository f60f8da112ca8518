"""Density-filter convolution backends.

The filter operator H (Filter.cc:404-440) is a dense (2s+1)^3 hat-kernel
convolution.  XLA's direct 3D single-channel convolution costs
O((2s+1)^3) per element, which grows quickly with the stencil, so two
backends are provided:

- "direct": lax.conv_general_dilated — fine for small stencils,
- "fft": zero-padded real-FFT convolution — exact linear convolution,
  cost independent of kernel size (a few FFTs), the default above a tap
  threshold.

Both reproduce the reference's zero-padded boundary truncation (Hs is
computed by convolving ones with the same backend).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def conv3d_direct(x: jax.Array, kernel: jax.Array) -> jax.Array:
    """SAME-padded direct convolution (kernel symmetric)."""
    lhs = x[None, None]
    rhs = kernel[None, None]
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1, 1, 1),
        padding="SAME",
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
    )
    return out[0, 0]


def next_smooth(n: int) -> int:
    """Smallest 5-smooth integer (2^a 3^b 5^c) >= n.

    Zero-padded linear convolution is exact for ANY transform size >=
    (signal + kernel - 1), so padding up to a smooth size is free
    correctness-wise and avoids large prime radices: the exact filter
    sizes at 384^3/512^3 (444 = 2^2*3*37, 592 = 2^4*37) carry a
    radix-37 factor.
    """
    m = max(int(n), 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def make_fft_conv(
    shape: Tuple[int, int, int],
    kernel: np.ndarray,
    dtype=jnp.float32,
    crop_offset: int = 0,
):
    """Precompute the kernel spectrum for linear FFT convolution on fields
    of the given shape.

    crop_offset=0: SAME/zero-pad semantics on a `shape`-sized field.
    crop_offset=s: VALID semantics for a pre-ghosted input of `shape`
    (used by the SPMD path after ghost_fill_elem), output shape - 2s.
    """
    s = (kernel.shape[0] - 1) // 2
    pad = 2 * s - 2 * crop_offset  # extra room for linear conv
    full = tuple(
        next_smooth(shape[a] + max(pad, 0)) for a in range(3)
    )
    f64 = dtype == jnp.float64
    real_dt = jnp.float64 if f64 else jnp.float32
    np_real = np.float64 if f64 else np.float32
    # host FFT in the TARGET precision (the spectrum is cast to it
    # anyway): at 512^3 the f64 transform of the (592)^3 zero-padded
    # kernel took ~20 host-minutes single-threaded; f32 + pocketfft
    # workers cuts giga-dof filter setup to a fraction of that
    k = np.zeros(full, np_real)
    k[: 2 * s + 1, : 2 * s + 1, : 2 * s + 1] = kernel
    # kernel centered at s: circular shift so center lands at origin
    k = np.roll(k, (-s, -s, -s), axis=(0, 1, 2))
    try:
        from scipy import fft as _sfft

        KF = _sfft.rfftn(k, workers=-1)
    except ImportError:  # pragma: no cover
        KF = np.fft.rfftn(k)
    # the spectrum travels as REAL arrays that callers thread through
    # their jit boundaries as arguments (large closures would be
    # embedded in the program as constants).  The hat kernel is EVEN-symmetric
    # (k[-i]=k[i] mod full after the center shift), so its DFT is real:
    # store only the real part — halves the resident spectrum (0.86 ->
    # 0.43 GB at 512^3) and turns the spectral product into a
    # complex*real multiply.  Checked numerically, with the two-array
    # fallback kept for any future asymmetric kernel.
    sym = float(np.abs(KF.imag).max()) <= 1e-5 * float(
        np.abs(KF.real).max()
    )
    if sym:
        consts = (jnp.asarray(KF.real.astype(np_real)),)
    else:  # pragma: no cover - all production kernels are symmetric
        consts = (
            jnp.asarray(KF.real.astype(np_real)),
            jnp.asarray(KF.imag.astype(np_real)),
        )
    o = crop_offset
    out_shape = tuple(shape[a] - 2 * o for a in range(3))

    def conv(x: jax.Array, consts) -> jax.Array:
        # consts is REQUIRED (no default): defaulting to the captured
        # spectrum would let a jitted call site silently re-embed the
        # >100 MB arrays as XLA constants (HTTP-413 compile rejection)
        if len(consts) == 1:
            kf = consts[0].astype(real_dt)
        else:  # pragma: no cover
            kf = jax.lax.complex(
                consts[0].astype(real_dt), consts[1].astype(real_dt)
            )
        xp = jnp.pad(
            x.astype(real_dt),
            [(0, full[a] - shape[a]) for a in range(3)],
        )
        XF = jnp.fft.rfftn(xp)
        out = jnp.fft.irfftn(XF * kf, s=full)
        return out[
            o : o + out_shape[0],
            o : o + out_shape[1],
            o : o + out_shape[2],
        ].astype(dtype)

    conv.consts = consts
    return conv


# taps above which the FFT path wins (measured: direct conv at 128^3 with
# 19^3 taps = 3.1 s vs ~10 ms of FFTs)
FFT_TAP_THRESHOLD = 343  # 7^3
