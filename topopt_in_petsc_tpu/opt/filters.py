"""Design-field regularization: density/sensitivity filters, Heaviside
projection, beta continuation, discreteness measure.

JAX equivalent of the reference Filter class (Filter.{h,cc}).  The
reference assembles an explicit sparse convolution matrix H with linear-hat
weights max(0, R - dist) over a box stencil plus a row-sum normalization Hs
(Filter.cc:324-448) and applies it via SpMV.  Here the same operator *is*
a 3D convolution: we precompute the (2s+1)^3 weight kernel once and apply
`lax.conv_general_dilated` with zero ('SAME') padding — the zero padding
reproduces the reference's boundary truncation exactly because Hs is
computed by convolving ones (== H row sums with boundary clipping).

filterType semantics follow TopOpt.cc:125: 0 = sensitivity filter,
1 = density filter (default), 2 = Helmholtz PDE filter (pde_filter.py),
anything else = no filtering.
"""

from __future__ import annotations

import math
import sys
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.ops.conv_filter import (
    FFT_TAP_THRESHOLD,
    conv3d_direct,
    make_fft_conv,
)


def filter_stencil_halfwidth(
    R: float, h: Tuple[float, float, float], nn: Tuple[int, int, int]
) -> int:
    """Stencil half-width 'ElemConn' (Filter.cc:324-332): per-axis
    ceil(R/h)-1, maxed over axes, clamped to half the node counts."""
    s = max(
        math.ceil(R / h[0]) - 1,
        math.ceil(R / h[1]) - 1,
        math.ceil(R / h[2]) - 1,
    )
    s = min(s, (nn[0] - 1) // 2, (nn[1] - 1) // 2, (nn[2] - 1) // 2)
    return max(int(s), 0)


def build_filter_kernel(
    R: float, h: Tuple[float, float, float], s: int, dtype=np.float64
) -> np.ndarray:
    """(2s+1)^3 linear-hat kernel w = max(0, R - dist) between element
    centers (the H-matrix insertion loop, Filter.cc:404-440)."""
    idx = np.arange(-s, s + 1, dtype=np.float64)
    DI, DJ, DK = np.meshgrid(idx * h[0], idx * h[1], idx * h[2],
                             indexing="ij")
    dist = np.sqrt(DI**2 + DJ**2 + DK**2)
    w = np.where(dist < R, R - dist, 0.0)
    return w.astype(dtype)


def smooth_projection(x, beta, eta):
    """Smoothed Heaviside (Filter.h:80-83):
    y = (tanh(b e) + tanh(b (x-e))) / (tanh(b e) + tanh(b (1-e)))."""
    num = jnp.tanh(beta * eta) + jnp.tanh(beta * (x - eta))
    den = jnp.tanh(beta * eta) + jnp.tanh(beta * (1.0 - eta))
    return num / den


def smooth_projection_chainrule(x, beta, eta):
    """d(projection)/dx (Filter.h:85-88)."""
    den = jnp.tanh(beta * eta) + jnp.tanh(beta * (1.0 - eta))
    return beta * (1.0 - jnp.tanh(beta * (x - eta)) ** 2) / den


class DesignFilter:
    """Dispatching filter front-end (Filter::FilterProject / Gradients)."""

    def __init__(self, cfg, grid):
        self.cfg = cfg
        self.grid = grid
        self.filterType = cfg.filter
        self.dtype = cfg.jnp_dtype
        self.pdef = None
        self.kernel = None
        self.Hs = None
        self._fft_conv = None
        self._fft_consts = None

        if self.filterType in (0, 1):
            s = filter_stencil_halfwidth(cfg.rmin, grid.h, grid.nn)
            self.stencil_halfwidth = s
            # stderr: bench.py's stdout contract is ONE json line, and
            # this banner fires from inside make_fused_step (Filter.cc
            # prints it too, but PETSc has no such stdout contract)
            print(
                f"# Filter radius rmin = {cfg.rmin:f} results in a "
                f"stencil of {s} elements",
                file=sys.stderr,
            )
            k = build_filter_kernel(cfg.rmin, grid.h, s)
            self.kernel = jnp.asarray(k, dtype=self.dtype)
            # backend: direct conv for small stencils, FFT for large
            # (XLA's direct 3D conv is pathologically slow above ~7^3)
            if (2 * s + 1) ** 3 > FFT_TAP_THRESHOLD:
                self._fft_conv = make_fft_conv(grid.ne, k, self.dtype)
                self._fft_consts = self._fft_conv.consts
            else:
                self._fft_conv = None
                self._fft_consts = None
            ones = jnp.ones(grid.ne, dtype=self.dtype)
            # spectra travel as ARGUMENTS rather than as embedded
            # constants (the 384^3+ FFT spectrum exceeds 100 MB)
            self.Hs = jax.jit(self._conv)(ones, self._fft_consts)
        elif self.filterType == 2:
            from topopt_in_petsc_tpu.opt.pde_filter import PDEFilter

            self.pdef = PDEFilter(cfg, grid)

        self._jit_project = jax.jit(
            self._project_impl, static_argnames=("projection",)
        )
        self._jit_gradients = jax.jit(
            self._gradients_impl, static_argnames=("projection",)
        )
        self._jit_mnd = jax.jit(self._mnd_impl)

    # -- convolution H (SpMV MatMult(H, x) equivalent) ------------------ #

    def _conv(self, x: jax.Array, fft_consts=None) -> jax.Array:
        if self._fft_conv is not None:
            if fft_consts is None:
                # fail loudly at TRACE time: falling back to the
                # captured spectrum would embed >100 MB as a constant
                # at any jitted call site that forgot to thread the
                # consts through
                raise ValueError(
                    "FFT filter backend active but fft_consts was not "
                    "passed through the jit boundary"
                )
            return self._fft_conv(x.astype(self.dtype), fft_consts)
        return conv3d_direct(x.astype(self.dtype), self.kernel)

    # -- FilterProject (Filter.cc:60-117) ------------------------------- #

    def _project_impl(self, x, beta, eta, Hs=None, fft_consts=None, *,
                      projection: bool):
        if self.filterType == 1:
            xTilde = self._conv(x, fft_consts) / Hs
        elif self.filterType == 2:
            xTilde, _ = self.pdef._project_core(x)
            xTilde = jnp.clip(xTilde, 0.0, 1.0)
        else:
            xTilde = x
        if projection:
            xPhys = smooth_projection(xTilde, beta, eta)
        else:
            xPhys = xTilde
        return xTilde, xPhys

    def filter_project(self, x, projection=None, beta=None, eta=None):
        cfg = self.cfg
        projection = (
            cfg.projectionFilter if projection is None else projection
        )
        beta = cfg.beta if beta is None else beta
        eta = cfg.eta if eta is None else eta
        if self.filterType == 2:
            # keep the PDE solver warm start outside jit
            return self.pdef.filter_project_with_projection(
                x, projection, beta, eta
            )
        return self._jit_project(
            x.astype(self.dtype),
            jnp.asarray(beta, self.dtype),
            jnp.asarray(eta, self.dtype),
            self.Hs,
            self._fft_consts,
            projection=bool(projection),
        )

    # -- Gradients (Filter.cc:120-204) ---------------------------------- #

    def _gradients_impl(self, x, xTilde, dfdx, dgdx, beta, eta, Hs=None,
                        fft_consts=None, *, projection: bool):
        if projection:
            dproj = smooth_projection_chainrule(xTilde, beta, eta)
            dfdx = dfdx * dproj
            dgdx = dgdx * dproj[None]
        if self.filterType == 0:
            # sensitivity filter: dfdx <- (H (dfdx o x)) / Hs / x
            # (Filter.cc:167-177; x floored at Xmin=0.001, TopOpt.cc:357)
            dfdx = self._conv(dfdx * x, fft_consts) / Hs / x
        elif self.filterType == 1:
            dfdx = self._conv(dfdx / Hs, fft_consts)
            dgdx = jnp.stack(
                [self._conv(dgdx[j] / Hs, fft_consts)
                 for j in range(dgdx.shape[0])]
            )
        return dfdx, dgdx

    def gradients(self, x, xTilde, dfdx, dgdx, projection=None, beta=None,
                  eta=None):
        cfg = self.cfg
        projection = (
            cfg.projectionFilter if projection is None else projection
        )
        beta = cfg.beta if beta is None else beta
        eta = cfg.eta if eta is None else eta
        if self.filterType == 2:
            return self.pdef.gradients_with_projection(
                x, xTilde, dfdx, dgdx, projection, beta, eta
            )
        return self._jit_gradients(
            x.astype(self.dtype),
            xTilde.astype(self.dtype),
            dfdx.astype(self.dtype),
            dgdx.astype(self.dtype),
            jnp.asarray(beta, self.dtype),
            jnp.asarray(eta, self.dtype),
            self.Hs,
            self._fft_consts,
            projection=bool(projection),
        )

    # -- continuation + metrics ----------------------------------------- #

    @staticmethod
    def increase_beta(beta, betaFinal, gx, itr, ch):
        """Beta continuation (Filter.cc:268-288).  Host-side scalars."""
        changed = False
        if (ch < 0.01 or itr % 10 == 0) and beta < betaFinal and gx < 1e-6:
            changed = True
            beta = beta + 1.0 if beta < 7 else beta * 1.2
            if beta > betaFinal:
                beta = betaFinal
                changed = False
            print(f"Beta has been increased to: {beta:f}")
        return beta, changed

    def _mnd_impl(self, x):
        return jnp.mean(4.0 * x * (1.0 - x))

    def get_mnd(self, xPhys) -> float:
        """Measure of non-discreteness mean(4 x (1-x)) (Filter.cc:206-225)."""
        return float(self._jit_mnd(xPhys))
