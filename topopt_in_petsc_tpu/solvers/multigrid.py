"""Geometric multigrid preconditioner on the structured hex grid.

JAX replacement for the reference's PCMG stack
(LinearElasticity.cc:654-746, PDEFilter.cc:290-380):

reference (PETSc)                       | this module (JAX)
----------------------------------------|--------------------------------------
DMCoarsenHierarchy (cc:689)             | Grid.hierarchy: static 2h grids
DMCreateInterpolation (cc:704)          | separable trilinear prolong/restrict
                                        |   (strided slice ops; R = P^T)
Galerkin RAP coarse ops (cc:702)        | rediscretized coarse hex operator
                                        |   with 2x2x2-averaged element scale
GMRES(4)+SOR smoothers (cc:734-746)     | Chebyshev(4)-Jacobi (matrix-free,
                                        |   parallel, keeps V-cycle SPD)
coarse GMRES(30)+SOR (cc:717-731)       | Jacobi-PCG, rtol 1e-8, maxit 30
multiplicative V-cycle (cc:699-700)     | V-cycle, recursion unrolled in jit

Dirichlet BCs: the fine-level mask trick K <- N'KN + (I-N)
(LinearElasticity.cc:530-538) is applied at *every* level with the mask
subsampled at coarse nodes (coarse nodes coincide with fine nodes), and
restriction/prolongation are masked so corrections never touch constrained
dofs (SURVEY hard-part #5).

Everything here is jit-traceable: `setup` consumes the (traced) fine-level
element scale each outer iteration and returns per-level scale/diagonal/
eigenvalue-estimate pytrees; grids, element matrices and masks are static.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.ops.hex_operator import (
    apply_hex_operator,
    apply_hex_operator_octant,
    hex_operator_absrowsum,
    hex_operator_diagonal,
    hex_operator_diagonal_octant,
    octant_split,
)
from topopt_in_petsc_tpu.models.elements import galerkin_octant_matrices
from topopt_in_petsc_tpu.solvers.cg import pcg
from topopt_in_petsc_tpu.solvers.chebyshev import (
    chebyshev_smooth,
    gershgorin_lambda_max,
)


# --------------------------------------------------------------------- #
# Transfer operators (DMCreateInterpolation equivalent): separable
# trilinear interpolation; restriction is its exact adjoint (R = P^T, the
# pairing PCMG's Galerkin mode uses).


def _interp_axis(u: jax.Array, axis: int) -> jax.Array:
    """Linear interpolation along one axis: size n -> 2n-1."""
    n = u.shape[axis]
    lo = jax.lax.slice_in_dim(u, 0, n - 1, axis=axis)
    hi = jax.lax.slice_in_dim(u, 1, n, axis=axis)
    mid = 0.5 * (lo + hi)
    shape = list(u.shape)
    shape[axis] = 2 * n - 1
    out = jnp.zeros(shape, u.dtype)
    even = [slice(None)] * u.ndim
    even[axis] = slice(0, None, 2)
    odd = [slice(None)] * u.ndim
    odd[axis] = slice(1, None, 2)
    out = out.at[tuple(even)].set(u)
    out = out.at[tuple(odd)].set(mid)
    return out


def prolong(uc: jax.Array) -> jax.Array:
    """Coarse (ncx,ncy,ncz,dof) -> fine (2ncx-1, ..., dof) trilinear."""
    u = uc
    for axis in range(3):
        u = _interp_axis(u, axis)
    return u


def _restrict_axis(f: jax.Array, axis: int) -> jax.Array:
    """Adjoint of _interp_axis: c[i] = f[2i] + 0.5 f[2i-1] + 0.5 f[2i+1]."""
    even = [slice(None)] * f.ndim
    even[axis] = slice(0, None, 2)
    odd = [slice(None)] * f.ndim
    odd[axis] = slice(1, None, 2)
    c = f[tuple(even)]
    mid = f[tuple(odd)]
    head = [slice(None)] * f.ndim
    head[axis] = slice(1, None)
    tail = [slice(None)] * f.ndim
    tail[axis] = slice(None, -1)
    c = c.at[tuple(head)].add(0.5 * mid)
    c = c.at[tuple(tail)].add(0.5 * mid)
    return c


def restrict(rf: jax.Array) -> jax.Array:
    """Fine -> coarse residual transfer, exact transpose of `prolong`."""
    r = rf
    for axis in range(3):
        r = _restrict_axis(r, axis)
    return r


def coarsen_cell_field(E: jax.Array) -> jax.Array:
    """2x2x2 arithmetic average of a per-element field (8-child averaging of
    the SIMP-scaled stiffness; SURVEY §7.1 'coarsen densities not
    operators'): reshape-sums on the two major axes, one even/odd slice
    pair on the minor axis."""
    ex, ey, ez = E.shape
    E = E.reshape(ex // 2, 2, ey, ez).sum(axis=1)
    E = E.reshape(ex // 2, ey // 2, 2, ez).sum(axis=2)
    E = E[..., 0::2] + E[..., 1::2]
    return E * 0.125


# --------------------------------------------------------------------- #


class GeometricMultigrid:
    """V-cycle preconditioner for the masked hex operator.

    Parameters
    ----------
    grids: fine-to-coarse Grid hierarchy (length nlvls).
    KEs:   per-level (8*dof, 8*dof) element matrices (numpy, static).
    masks: per-level (nx,ny,nz,dof) 0/1 Dirichlet masks, or None (pure
           Neumann problem, e.g. the Helmholtz filter).
    """

    def __init__(
        self,
        grids: Sequence,
        KEs: Sequence[np.ndarray],
        masks: Optional[Sequence[np.ndarray]],
        dof: int,
        *,
        dtype=jnp.float32,
        smooth_sweeps: int = 4,
        cheby_lower: float = 0.06,
        cheby_upper: float = 1.1,
        coarse_rtol: float = 1e-8,
        coarse_maxit: int = 30,
        precise_dots: bool = True,
        coarse_op: str = "rediscretize",
        precond_dtype=None,
        fine_apply=None,
    ):
        # precond_dtype: run the whole V-cycle in a lower precision
        # (bf16): the preconditioner only steers CG, so its rounding
        # costs a few extra FCG iterations while halving the V-cycle's
        # memory traffic; flexible CG absorbs the nonstationarity.
        # None = same dtype as the operator.
        self.precond_dtype = precond_dtype
        self.grids = tuple(grids)
        self.nlvls = len(self.grids)
        self.dof = dof
        self.dtype = dtype
        self.KEs = [jnp.asarray(ke, dtype=dtype) for ke in KEs]
        # Galerkin octant matrices: level l's element operator is the
        # projection of level l-1's (sum_p w_p T_p^T KE_{l-1} T_p) —
        # exact Galerkin at level 1, octant-averaged deeper (replaces the
        # reference's RAP, LinearElasticity.cc:702; plain 8-child scalar
        # averaging loses the sub-element stiffness distribution and
        # stalls at high SIMP contrast).
        self.coarse_op = coarse_op
        if coarse_op == "galerkin_octant":
            self.KEps = [None] + [
                jnp.asarray(
                    galerkin_octant_matrices(np.asarray(KEs[l - 1]), dof),
                    dtype=dtype,
                )
                for l in range(1, self.nlvls)
            ]
        else:
            self.KEps = [None] * self.nlvls
        # Masks are *not* captured into jitted programs as constants —
        # at 256^3+ a closed-over (nx,ny,nz,3) mask would be a >200 MB
        # constant in the compiled program.  They are returned by
        # `mask_args()` and flow through `setup`/`apply` as arguments.
        if masks is None:
            self.masks = None
        else:
            self.masks = [jnp.asarray(m, dtype=dtype) for m in masks]
        self.smooth_sweeps = smooth_sweeps
        self.cheby_lower = cheby_lower
        self.cheby_upper = cheby_upper
        self.coarse_rtol = coarse_rtol
        self.coarse_maxit = coarse_maxit
        self.precise_dots = precise_dots
        # optional fused fine-level K@u (ops/select.make_fine_apply):
        # apply(v, coef) -> K v with free BCs, float32 only — a
        # reduced-precision V-cycle keeps the XLA form
        self.fine_apply = fine_apply

    # -- per-level masked operator ------------------------------------ #

    def _raw_apply(self, level: int, coef: jax.Array, v: jax.Array):
        if level == 0 and self.fine_apply is not None and \
                v.dtype == jnp.float32:
            return self.fine_apply(v, coef)
        if level == 0 or self.coarse_op != "galerkin_octant":
            return apply_hex_operator(v, coef, self.KEs[level])
        return apply_hex_operator_octant(v, coef, self.KEps[level])

    def _raw_diag(self, level: int, coef: jax.Array, nn):
        if level == 0 or self.coarse_op != "galerkin_octant":
            return hex_operator_diagonal(coef, self.KEs[level], nn)
        return hex_operator_diagonal_octant(coef, self.KEps[level], nn)

    def _raw_absrowsum(self, level: int, coef: jax.Array, ones):
        if level == 0 or self.coarse_op != "galerkin_octant":
            # stencil form: no (nelem, 8*dof) gather transient
            return hex_operator_absrowsum(
                coef, self.KEs[level], ones.shape[:3]
            )
        return apply_hex_operator_octant(
            ones, coef, jnp.abs(self.KEps[level])
        )

    def mask_args(self):
        """Per-level masks as a pytree to pass through jit boundaries."""
        return self.masks

    def apply(self, level: int, coef: jax.Array, v: jax.Array,
              masks=None) -> jax.Array:
        """A_l v = N (K_l (N v)) + (I - N) v   (LinearElasticity.cc:530-538,
        applied matrix-free at every level)."""
        if masks is None:
            return self._raw_apply(level, coef, v)
        N = masks[level]
        Kv = self._raw_apply(level, coef, N * v)
        return N * Kv + (1.0 - N) * v

    # -- setup (traced; called once per outer iteration) -------------- #

    def _level_coefs(self, scale_fine: jax.Array) -> List[jax.Array]:
        """Per-level operator coefficients from the fine element scale:
        level 0 the scale itself; deeper levels (galerkin_octant) the
        octant split of the previous level's scale; (rediscretize) the
        8-child average."""
        Es = [scale_fine.astype(self.dtype)]
        for l in range(1, self.nlvls):
            Es.append(coarsen_cell_field(Es[-1]))
        if self.coarse_op != "galerkin_octant":
            return Es
        return [Es[0]] + [octant_split(Es[l - 1])
                          for l in range(1, self.nlvls)]

    def setup(self, scale_fine: jax.Array, masks=None) -> List[dict]:
        """Build per-level {coef, dinv, lmax, mask} from the fine element
        scale.  `masks` must be passed as (traced) arguments, not
        captured (see __init__ note).

        lmax uses the certain Gershgorin-style bound (one |KE| matvec of
        ones) — power iteration can underestimate at high SIMP contrast,
        which makes Chebyshev divergent in f32 (SURVEY hard-part #3).
        """
        levels = []
        for l, coef in enumerate(self._level_coefs(scale_fine)):
            nn = self.grids[l].nn
            d = self._raw_diag(l, coef, nn)
            mask = None if masks is None else masks[l]
            if mask is not None:
                d = mask * d + (1.0 - mask)
            ones = jnp.ones((nn[0], nn[1], nn[2], self.dof), self.dtype)
            R = self._raw_absrowsum(l, coef, ones)
            lmax = gershgorin_lambda_max(R, d, mask)
            levels.append({"coef": coef, "dinv": 1.0 / d, "lmax": lmax,
                           "mask": mask})
        return levels

    # -- V-cycle ------------------------------------------------------ #

    @staticmethod
    def _mask_of(levels, level, v):
        m = levels[level]["mask"]
        return v if m is None else m * v

    def vcycle(self, levels: List[dict], b: jax.Array, level: int = 0):
        """One multiplicative V(s,s) cycle; returns z ~= A^-1 b."""
        lvl = levels[level]
        masks = [l["mask"] for l in levels] if lvl["mask"] is not None \
            else None
        A = lambda v: self.apply(level, lvl["coef"], v, masks)

        if level == self.nlvls - 1:
            res = pcg(
                A,
                b,
                jnp.zeros_like(b),
                M=lambda r: lvl["dinv"] * r,
                rtol=self.coarse_rtol,
                maxiter=self.coarse_maxit,
                flexible=False,
                precise_dots=self.precise_dots,
            )
            return res.x

        smooth = lambda bb, xx, **kw: chebyshev_smooth(
            A,
            bb,
            xx,
            lvl["dinv"],
            lvl["lmax"],
            degree=self.smooth_sweeps,
            lower=self.cheby_lower,
            upper=self.cheby_upper,
            **kw,
        )

        # presmooth from zero: skip the A(0) application entirely
        x = smooth(b, b, x_is_zero=True)
        r = b - A(x)
        rc = self._mask_of(levels, level + 1, restrict(r))
        ec = self.vcycle(levels, rc, level + 1)
        x = x + self._mask_of(levels, level, prolong(ec))
        x = smooth(b, x)
        return x

    def preconditioner(self, levels: List[dict]) -> Callable:
        if self.precond_dtype is None:
            return lambda r: self.vcycle(levels, r)
        pdt = self.precond_dtype

        def cast_level(lvl):
            out = {}
            for k, v in lvl.items():
                if v is None:
                    out[k] = None
                elif k == "lmax":
                    # keep the eigenvalue bound in f32
                    out[k] = v
                else:
                    out[k] = v.astype(pdt)
            return out

        def M(r):
            lvls = [cast_level(l) for l in levels]
            z = self.vcycle_cast(lvls, r.astype(pdt))
            return z.astype(r.dtype)

        return M

    def vcycle_cast(self, levels, b, level: int = 0):
        """vcycle on pre-cast levels, with element matrices cast too."""
        pdt = self.precond_dtype
        saved = (self.KEs, self.KEps)
        self.KEs = [k.astype(pdt) for k in self.KEs]
        self.KEps = [None if k is None else k.astype(pdt)
                     for k in self.KEps]
        try:
            return self.vcycle(levels, b, level)
        finally:
            self.KEs, self.KEps = saved
