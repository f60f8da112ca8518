"""Linear elasticity physics: cantilever BC/load, state solve, compliance.

JAX equivalent of the reference LinearElasticity class
(LinearElasticity.{h,cc}): owns the 3-dof nodal field layout, the constant
24x24 Hex8 element stiffness, the Dirichlet mask N and load RHS, the
MG-preconditioned Krylov state solver, and the objective/constraint/
sensitivity computation.

Differences by design (idiomatic JAX, see SURVEY §7.1):
 - no assembled stiffness matrix: `K(x) @ u` is matrix-free — the fused
   kernel of ops.hex_triton on a GPU, the gather-matmul-scatter of
   ops.hex_operator elsewhere (ops/select.py decides),
 - outer Krylov is flexible PCG (K is SPD) instead of FGMRES,
 - multigrid uses Chebyshev-Jacobi smoothers + rediscretized coarse
   operators instead of GMRES/SOR + Galerkin RAP,
 - the whole per-iteration physics step (assemble + solve + objective +
   sensitivities) is one jitted function.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops.hex_operator import element_quadratic_form
from topopt_in_petsc_tpu.ops.select import make_fine_apply, resolve_operator
from topopt_in_petsc_tpu.solvers.cg import accurate_sum, pcg
from topopt_in_petsc_tpu.solvers.multigrid import GeometricMultigrid


def build_cantilever_bc(grid: Grid, dtype=np.float64):
    """Dirichlet mask N and load RHS for the reference cantilever problem
    (LinearElasticity.cc:143-171):

      - wall at x = xcmin fully clamped (all 3 dofs zero),
      - line load F_z = -0.001 along the edge (x = xcmax, z = zcmin),
        halved at the two corners (y = ycmin and y = ycmax).

    The reference finds these nodes by coordinate matching with
    epsilon = 0.05*min(dx,dy,dz); on the structured grid they are exactly
    the index sets i==0, (i==nx-1, k==0).
    """
    nx, ny, nz = grid.nn
    N = np.ones((nx, ny, nz, 3), dtype=dtype)
    N[0, :, :, :] = 0.0  # clamped wall

    RHS = np.zeros((nx, ny, nz, 3), dtype=dtype)
    load = -0.001
    RHS[nx - 1, :, 0, 2] = load
    RHS[nx - 1, 0, 0, 2] = load / 2.0
    RHS[nx - 1, ny - 1, 0, 2] = load / 2.0

    # Zero loads coinciding with Dirichlet dofs (RHS <- RHS o N,
    # LinearElasticity.cc:542). No overlap for this BC set, but keep the
    # invariant for custom problems.
    RHS *= N
    return N, RHS


class PhysicsResult(NamedTuple):
    u: jax.Array  # state field (nx, ny, nz, 3)
    iters: jax.Array  # Krylov iterations
    relres: jax.Array  # final relative residual
    fx: jax.Array  # compliance  U^T K U
    gx: jax.Array  # (m,) constraints; gx[0] = mean(xPhys) - volfrac
    dfdx: jax.Array  # (ex, ey, ez) compliance sensitivity
    dgdx: jax.Array  # (m, ex, ey, ez) constraint sensitivities


class LinearElasticity:
    """Cantilever elasticity on the structured grid (LinearElasticity.cc)."""

    def __init__(self, cfg, grid: Grid | None = None):
        self.cfg = cfg
        self.grid = grid or Grid.from_config(cfg)
        self.dtype = cfg.jnp_dtype

        dx, dy, dz = self.grid.h
        self.KE = jnp.asarray(
            hex8_stiffness(dx, dy, dz, cfg.nu), dtype=self.dtype
        )

        # Multigrid hierarchy: per-level element matrices from the 2h
        # rediscretization; per-level masks by node subsampling (coarse
        # nodes coincide with fine nodes at even indices).
        grids = self.grid.hierarchy(cfg.nlvls)
        KEs = [hex8_stiffness(*g.h, cfg.nu) for g in grids]
        # fine-level K@u (outer Krylov AND the fine V-cycle level, where
        # the smoothing sweeps spend most of the solve): ops/select.py
        impl = resolve_operator(cfg.operator_impl, cfg.dtype)
        fine_apply = make_fine_apply(impl, KEs[0])

        N_np, RHS_np = build_cantilever_bc(self.grid)
        self.N = jnp.asarray(N_np, dtype=self.dtype)
        self.RHS = jnp.asarray(RHS_np, dtype=self.dtype)
        masks = []
        m = N_np
        for l in range(cfg.nlvls):
            masks.append(m)
            m = m[::2, ::2, ::2]

        self.mg = GeometricMultigrid(
            grids,
            KEs,
            masks,
            dof=3,
            dtype=self.dtype,
            smooth_sweeps=cfg.smooth_sweeps,
            cheby_lower=cfg.cheby_lower,
            cheby_upper=cfg.cheby_upper,
            coarse_rtol=cfg.coarse_rtol,
            coarse_maxit=cfg.coarse_maxit,
            precise_dots=cfg.precise_dots,
            coarse_op=cfg.coarse_op,
            precond_dtype=(
                jnp.bfloat16 if cfg.mg_dtype == "bfloat16" else None
            ),
            fine_apply=fine_apply,
        )

        self._step = jax.jit(self._step_impl)
        # donate the warm-start buffer into the solution (the caller
        # replaces its reference with res.u): saves one full nodal
        # vector of device memory
        self._solve = jax.jit(self._solve_impl, donate_argnums=(1,))
        self._objective = jax.jit(self._objective_parts)

    # -- SIMP interpolation (LinearElasticity.cc:519) ------------------ #

    def simp(self, xPhys: jax.Array) -> jax.Array:
        cfg = self.cfg
        return cfg.Emin + xPhys**cfg.penal * (cfg.Emax - cfg.Emin)

    # -- state solve --------------------------------------------------- #

    def mask_args(self):
        """Per-level Dirichlet masks for the jit boundary."""
        return self.mg.mask_args()

    def _solve_impl(self, xPhys, u0, rhs, masks):
        # rhs/masks arrive as jit ARGUMENTS: closing over them would
        # embed (nx,ny,nz,3)-sized constants (hundreds of MB at 256^3+)
        # in the compiled program.
        cfg = self.cfg
        E = self.simp(xPhys.astype(self.dtype))
        levels = self.mg.setup(E, masks)
        A = lambda v: self.mg.apply(0, E, v, masks)
        M = self.mg.preconditioner(levels)
        if cfg.ksp_type == "fgmres":
            # the reference's own outer method (LinearElasticity.cc:638)
            from topopt_in_petsc_tpu.solvers.gmres import fgmres

            return fgmres(
                A, rhs, u0, M,
                rtol=cfg.ksp_rtol,
                maxiter=cfg.ksp_maxit,
                restart=cfg.ksp_gmres_restart,
                precise_dots=cfg.precise_dots,
            )
        res = pcg(
            A,
            rhs,
            u0,
            M,
            rtol=cfg.ksp_rtol,
            maxiter=cfg.ksp_maxit,
            flexible=True,
            precise_dots=cfg.precise_dots,
        )
        return res

    def solve_state(self, xPhys, u0=None):
        """SolveState (LinearElasticity.cc:182-223): re-'assemble' (set the
        element scale), rebuild the MG setup, solve with warm start.

        NOTE: the warm-start buffer `u0` is DONATED into the solution
        (one nodal vector of device memory saved); it must not be used after the
        call — keep `res.x` instead (the driver does)."""
        if u0 is None:
            u0 = jnp.zeros((*self.grid.nn, 3), dtype=self.dtype)
        return self._solve(xPhys, u0, self.RHS, self.mask_args())

    # -- objective / constraints / sensitivities ----------------------- #

    def _objective_parts(self, xPhys, u):
        cfg = self.cfg
        uKu = element_quadratic_form(u, self.KE)  # (ex, ey, ez)
        E = self.simp(xPhys)
        # chunked accurate sums: no full-size f64 transients
        # (solvers/cg.accurate_sum)
        fx = accurate_sum(E * uKu, cfg.precise_dots)
        nelem = xPhys.size
        gx0 = accurate_sum(xPhys, cfg.precise_dots) / nelem - cfg.volfrac
        dfdx = (
            -cfg.penal * xPhys ** (cfg.penal - 1.0) * (cfg.Emax - cfg.Emin)
        ) * uKu
        dgdx = jnp.full(
            (cfg.m,) + xPhys.shape, 1.0 / nelem, dtype=self.dtype
        )
        gx = jnp.concatenate(
            [
                jnp.asarray([gx0], dtype=self.dtype),
                jnp.zeros((cfg.m - 1,), dtype=self.dtype),
            ]
        )
        return fx.astype(self.dtype), gx, dfdx, dgdx

    def _step_impl(self, xPhys, u0, rhs, masks) -> PhysicsResult:
        res = self._solve_impl(xPhys, u0, rhs, masks)
        fx, gx, dfdx, dgdx = self._objective_parts(
            xPhys.astype(self.dtype), res.x
        )
        return PhysicsResult(
            u=res.x,
            iters=res.iters,
            relres=res.relres,
            fx=fx,
            gx=gx,
            dfdx=dfdx,
            dgdx=dgdx,
        )

    def compute_objective_constraints_sensitivities(
        self, xPhys, u0=None
    ) -> PhysicsResult:
        """ComputeObjectiveConstraintsSensitivities
        (LinearElasticity.cc:363-445).

        Runs as TWO programs (solve, then objective), so the objective's
        (nelem, 24) gather never sits on top of the solver's peak
        buffers; the fused step (_step_impl) traces both into one."""
        res = self.solve_state(xPhys, u0)
        fx, gx, dfdx, dgdx = self._objective(
            xPhys.astype(self.dtype), res.x
        )
        return PhysicsResult(
            u=res.x, iters=res.iters, relres=res.relres,
            fx=fx, gx=gx, dfdx=dfdx, dgdx=dgdx,
        )

    def compute_objective_constraints(self, xPhys, u0=None):
        """Split variant (LinearElasticity.cc:225-297)."""
        r = self.compute_objective_constraints_sensitivities(xPhys, u0)
        return r.fx, r.gx, r

    def compute_sensitivities(self, xPhys, u):
        """Split variant (LinearElasticity.cc:299-361): sensitivities from an
        existing state field."""
        _, _, dfdx, dgdx = self._objective_parts(
            xPhys.astype(self.dtype), u
        )
        return dfdx, dgdx
