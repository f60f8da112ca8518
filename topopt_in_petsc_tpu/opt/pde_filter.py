"""Helmholtz PDE filter: (-R^2 lap + I) u_tilde = T x, xTilde = T^T u_tilde.

JAX equivalent of the reference PDEFilt class (PDEFilter.{h,cc}).
R = rmin / (2 sqrt(3)) converts the convolution radius to the Helmholtz
length scale (PDEFilter.cc:30).  The reference assembles a nodal Helmholtz
matrix K, a rectangular element->node map T with 1/8 weights, and solves
with FGMRES + 3-level PCMG (Jacobi smoothers, Galerkin); here the operator
is the same matrix-free hex machinery with dof=1 and unit element scale,
solved by CG + 3-level geometric multigrid with Chebyshev-Jacobi smoothers.
The operator is density-independent, so the MG setup (diagonals, eigenvalue
estimates) is computed once at construction.

The filter map is self-adjoint — Gradients() == FilterProject()
(PDEFilter.cc:218).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.models.elements import helmholtz_element_matrices
from topopt_in_petsc_tpu.ops.hex_operator import (
    gather_element_dofs,
    scatter_element_dofs,
)
from topopt_in_petsc_tpu.opt import filters as _filters
from topopt_in_petsc_tpu.solvers.cg import pcg
from topopt_in_petsc_tpu.solvers.multigrid import GeometricMultigrid


class PDEFilter:
    def __init__(self, cfg, grid):
        self.cfg = cfg
        self.grid = grid
        self.dtype = cfg.jnp_dtype
        self.R = cfg.rmin / (2.0 * np.sqrt(3.0))

        nlvls = cfg.pde_nlvls
        # The PDE filter grid must also support its own hierarchy.
        div = 2 ** (nlvls - 1)
        for n in grid.ne:
            if n % div != 0:
                raise ValueError(
                    f"PDE filter: element count {n} not divisible by {div}"
                )
        grids = grid.hierarchy(nlvls)
        KFs = [
            helmholtz_element_matrices(*g.h, self.R)[0] for g in grids
        ]
        self.mg = GeometricMultigrid(
            grids,
            KFs,
            None,  # pure Neumann: no Dirichlet mask
            dof=1,
            dtype=self.dtype,
            smooth_sweeps=max(2, cfg.smooth_sweeps // 2),
            coarse_rtol=1e-8,
            coarse_maxit=10,
            precise_dots=cfg.precise_dots,
        )
        # Density-independent operator: one-time MG setup with unit scale.
        ones = jnp.ones(grid.ne, dtype=self.dtype)
        self._levels = jax.jit(lambda e: self.mg.setup(e, None))(ones)
        self._ones = ones
        self.elem_volume = grid.elem_volume

        # warm-start state (KSPSetInitialGuessNonzero, PDEFilter.cc:285)
        nn = grid.nn
        self._u = jnp.zeros((nn[0], nn[1], nn[2], 1), dtype=self.dtype)

        self._jit_solve = jax.jit(self._solve_impl)

        # constructor smoke test, like PDEFilter.cc:175-187
        test = jax.random.uniform(
            jax.random.PRNGKey(0), grid.ne, dtype=self.dtype
        )
        self._project_core_host(test)
        print("Done setting up the PDEFilter")

    # -- T and T^T ------------------------------------------------------ #

    def _T_apply(self, x: jax.Array) -> jax.Array:
        """RHS = elemVol * T x: each element spreads x_e/8 to its corners
        (PDEFilter.cc:198-202 MatMult(T,...) + VecScale(elemVol))."""
        fe = jnp.repeat(x[..., None] * 0.125, 8, axis=-1)  # (ex,ey,ez,8)
        return self.elem_volume * scatter_element_dofs(fe, self.grid.nn)

    def _Tt_apply(self, u: jax.Array) -> jax.Array:
        """xTilde = T^T u: average of the 8 corner node values
        (PDEFilter.cc:210 MatMultTranspose)."""
        ue = gather_element_dofs(u)  # (ex,ey,ez,8)
        return ue.mean(axis=-1)

    # -- solve ----------------------------------------------------------- #

    def _solve_impl(self, x, u0, levels):
        cfg = self.cfg
        rhs = self._T_apply(x)
        A = lambda v: self.mg.apply(0, levels[0]["coef"], v)
        M = self.mg.preconditioner(levels)
        res = pcg(
            A,
            rhs,
            u0,
            M,
            rtol=cfg.pde_rtol,
            maxiter=cfg.pde_maxit,
            flexible=True,
            precise_dots=cfg.precise_dots,
        )
        return res.x, self._Tt_apply(res.x), res.iters, res.relres

    def _project_core(self, x):
        """Traced core (cold start; used when fused into other jits)."""
        u, xt, _, _ = self._solve_impl(
            x, jnp.zeros_like(self._u), self._levels
        )
        return xt, u

    def _project_core_host(self, x):
        """Host-level call keeping the warm-start state."""
        u, xt, iters, relres = self._jit_solve(
            x.astype(self.dtype), self._u, self._levels
        )
        self._u = u
        return xt, int(iters), float(relres)

    # -- public API mirroring Filter type 2 ------------------------------ #

    def filter_project(self, x):
        xt, iters, relres = self._project_core_host(x)
        return xt

    def filter_project_with_projection(self, x, projection, beta, eta):
        xt, iters, relres = self._project_core_host(x)
        # bound-violation clip (Filter.cc:76-101)
        viol = float(
            jnp.maximum(jnp.max(-xt), jnp.max(xt - 1.0))
        )
        if viol > 1e-4:
            print(
                "BOUND VIOLATION IN PDEFILTER - INCREASE RMIN OR MESH "
                f"RESOLUTION: xPhys = {viol:f}"
            )
        xt = jnp.clip(xt, 0.0, 1.0)
        if projection:
            xPhys = _filters.smooth_projection(xt, beta, eta)
        else:
            xPhys = xt
        return xt, xPhys

    def gradients(self, s):
        """Self-adjoint: Gradients == FilterProject (PDEFilter.cc:218)."""
        return self.filter_project(s)

    def gradients_with_projection(self, x, xTilde, dfdx, dgdx, projection,
                                  beta, eta):
        if projection:
            dproj = _filters.smooth_projection_chainrule(xTilde, beta, eta)
            dfdx = dfdx * dproj
            dgdx = dgdx * dproj[None]
        dfdx = self.filter_project(dfdx)
        dgdx = jnp.stack(
            [self.filter_project(dgdx[j]) for j in range(dgdx.shape[0])]
        )
        return dfdx, dgdx
