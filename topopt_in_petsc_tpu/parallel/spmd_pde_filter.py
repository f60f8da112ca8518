"""SPMD Helmholtz PDE filter over the halo engine.

Distributed version of opt.pde_filter.PDEFilter (reference
PDEFilter.{h,cc}): the nodal Helmholtz solve (-R^2 lap + I) u = elemVol*T x
runs inside one shard_map region — local hex operator applications with
ppermute halo completion, CG + geometric multigrid with Chebyshev-Jacobi
smoothing, element<->node maps T/T^T as local scatter/gather (the scatter
completed by one halo_accumulate).  Self-adjoint: gradients == project.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from topopt_in_petsc_tpu.models.elements import helmholtz_element_matrices
from topopt_in_petsc_tpu.ops.hex_operator import (
    gather_element_dofs,
    scatter_element_dofs,
)
from topopt_in_petsc_tpu.parallel.spmd import (
    AXIS_NAMES,
    SpmdMultigrid,
    halo_accumulate,
    make_psum_dot,
    peel,
    unpeel,
)
from topopt_in_petsc_tpu.solvers.cg import pcg

BLK = P(*AXIS_NAMES)
REP = P()


class SpmdPDEFilter:
    def __init__(self, cfg, decomp, mesh):
        self.cfg = cfg
        self.decomp = decomp
        self.mesh = mesh
        self.mesh_shape = decomp.mesh_shape
        self.dtype = cfg.jnp_dtype
        self.R = cfg.rmin / (2.0 * np.sqrt(3.0))
        grid = decomp.grid
        self.elem_volume = grid.elem_volume

        nlvls = min(cfg.pde_nlvls, decomp.nlvls)
        # a PDE-filter decomp with its own level count
        from topopt_in_petsc_tpu.parallel.decomp import BlockDecomp

        self.pde_decomp = BlockDecomp(grid, self.mesh_shape, nlvls)
        grids = grid.hierarchy(nlvls)
        KFs = [helmholtz_element_matrices(*g.h, self.R)[0] for g in grids]
        self.mg = SpmdMultigrid(
            self.pde_decomp,
            KFs,
            dof=1,
            dtype=self.dtype,
            smooth_sweeps=max(2, cfg.smooth_sweeps // 2),
            coarse_rtol=1e-8,
            coarse_maxit=10,
            precise_dots=cfg.precise_dots,
            coarse_op=cfg.coarse_op,
        )
        env_np = self.mg.build_static_env(None)
        put = lambda a: jax.device_put(a, NamedSharding(self.mesh, BLK))
        self.env_blk = jax.tree_util.tree_map(put, env_np)
        env_spec = jax.tree_util.tree_map(lambda _: BLK, self.env_blk)

        mx, my, mz = self.mesh_shape
        nxl, nyl, nzl = self.pde_decomp.local_nn(0)
        np_dt = np.float64 if cfg.dtype == "float64" else np.float32
        self.u_blk = put(
            np.zeros((mx, my, mz, nxl, nyl, nzl, 1), np_dt)
        )

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(BLK, BLK, env_spec),
            out_specs=(BLK, BLK, REP, REP),
            check_vma=False,
        )
        def run(x_blk, u0_blk, env_blk):
            x = peel(x_blk)
            u0 = peel(u0_blk)
            env = jax.tree_util.tree_map(peel, env_blk)
            xt, u, iters, relres = self._solve_local(x, u0, env)
            return unpeel(u), unpeel(xt), iters, relres

        self._run = jax.jit(run)

    # -- local (inside shard_map) -------------------------------------- #

    def _T_apply(self, x):
        fe = jnp.repeat(x[..., None] * 0.125, 8, axis=-1)
        nn = tuple(s + 1 for s in x.shape)
        out = scatter_element_dofs(fe, nn)
        return self.elem_volume * halo_accumulate(out, self.mesh_shape)

    def _Tt_apply(self, u):
        return gather_element_dofs(u).mean(axis=-1)

    def _setup_local(self, env, elem_shape):
        """One-time (per program) MG setup: the Helmholtz operator is
        density-independent, so the env is prepared with unit densities
        and shared across all solves of an optimization step."""
        ones = jnp.ones(elem_shape, self.dtype)
        return self.mg.setup(env, ones)

    def _solve_local(self, x, u0, env):
        env = self._setup_local(env, x.shape)
        return self._solve_prepared(x, u0, env)

    def _solve_prepared(self, x, u0, env):
        cfg = self.cfg
        rhs = self._T_apply(x.astype(self.dtype))
        A = partial(self.mg.apply, 0, env)
        M = lambda r: self.mg.vcycle(env, r)
        dot = make_psum_dot(env[0]["w"], cfg.precise_dots)
        res = pcg(
            A, rhs, u0, M,
            rtol=cfg.pde_rtol, maxiter=cfg.pde_maxit,
            flexible=True, dot=dot,
        )
        xt = self._Tt_apply(res.x)
        return xt, res.x, res.iters, res.relres

    # -- host API (blocked arrays, warm start kept) -------------------- #

    def filter_project(self, x_blk):
        u, xt, iters, relres = self._run(x_blk, self.u_blk, self.env_blk)
        self.u_blk = u
        return xt

    def gradients(self, s_blk):
        """Self-adjoint (PDEFilter.cc:218)."""
        return self.filter_project(s_blk)
