"""SPMD elasticity solve + fully-fused SPMD optimization step.

Wraps the halo engine (parallel.spmd) into user-facing entry points that
take *blocked* global arrays (leading device axes, see parallel.decomp)
and run the whole computation inside one `shard_map` region over the
('x','y','z') mesh:

  - `SpmdElasticity`: state solve + objective/constraints/sensitivities
    (the reference's ComputeObjectiveConstraintsSensitivities,
    LinearElasticity.cc:363-445, distributed),
  - `make_spmd_fused_step`: physics + density filter + MMA in a single
    SPMD program (one optimization iteration of main.cc:54-123).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elasticity import build_cantilever_bc
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops.hex_operator import element_quadratic_form
from topopt_in_petsc_tpu.ops.select import make_fine_apply, resolve_operator
from topopt_in_petsc_tpu.opt.filters import (
    build_filter_kernel,
    filter_stencil_halfwidth,
)
from topopt_in_petsc_tpu.opt.mma import MMA
from topopt_in_petsc_tpu.parallel.decomp import BlockDecomp
from topopt_in_petsc_tpu.parallel.mesh import make_device_mesh
from topopt_in_petsc_tpu.parallel.spmd import (
    AXIS_NAMES,
    SpmdMultigrid,
    ghost_fill_elem,
    halo_accumulate,
    make_psum_dot,
    peel,
    pmax_scalar,
    psum_scalar,
    unpeel,
)
from topopt_in_petsc_tpu.solvers.cg import pcg

BLK = P(*AXIS_NAMES)  # blocked arrays: leading device axes split
REP = P()  # replicated scalars/vectors


def _spec_like(tree, spec):
    return jax.tree_util.tree_map(lambda _: spec, tree)


class SpmdElasticity:
    """Distributed cantilever elasticity on an (mx,my,mz) device mesh."""

    def __init__(self, cfg: TopOptConfig, mesh: Mesh | None = None):
        cfg.validate()
        self.cfg = cfg
        self.grid = Grid.from_config(cfg)
        self.mesh_shape = tuple(cfg.mesh_shape)
        self.mesh = mesh or make_device_mesh(self.mesh_shape)
        self.decomp = BlockDecomp(self.grid, self.mesh_shape, cfg.nlvls)
        self.dtype = cfg.jnp_dtype
        np_dt = np.float64 if cfg.dtype == "float64" else np.float32

        grids = self.grid.hierarchy(cfg.nlvls)
        KEs = [hex8_stiffness(*g.h, cfg.nu) for g in grids]
        # fine-level LOCAL operator (ops/select.py), built for the
        # per-device block shape; halo_accumulate completes it across
        # blocks
        impl = resolve_operator(cfg.operator_impl, cfg.dtype)
        self.mg = SpmdMultigrid(
            self.decomp,
            KEs,
            dof=3,
            dtype=self.dtype,
            smooth_sweeps=cfg.smooth_sweeps,
            cheby_lower=cfg.cheby_lower,
            cheby_upper=cfg.cheby_upper,
            coarse_rtol=cfg.coarse_rtol,
            coarse_maxit=cfg.coarse_maxit,
            precise_dots=cfg.precise_dots,
            coarse_op=cfg.coarse_op,
            fine_apply=make_fine_apply(impl, KEs[0]),
            precond_dtype=(
                jnp.bfloat16 if cfg.mg_dtype == "bfloat16" else None
            ),
        )

        N_np, RHS_np = build_cantilever_bc(self.grid, dtype=np_dt)
        masks = []
        mcur = N_np
        for l in range(cfg.nlvls):
            masks.append(mcur)
            mcur = mcur[::2, ::2, ::2]
        env_np = self.mg.build_static_env(masks)
        self.rhs_blk = self._put_blk(
            self.decomp.to_blocked_nodal(RHS_np).astype(np_dt)
        )
        self.env_blk = jax.tree_util.tree_map(self._put_blk, env_np)
        self.KE_fine = jnp.asarray(KEs[0], self.dtype)

        self._solve_sm = self._build_solve()

    def _put_blk(self, arr):
        # multi-host-safe: make_array_from_callback places only this process's
        # addressable blocks (device_put of a host-global array fails
        # on multi-host where shards are non-addressable)
        from topopt_in_petsc_tpu.parallel.podio import put_blocked

        return put_blocked(arr, NamedSharding(self.mesh, BLK))

    def put_rep(self, value):
        """A host scalar/vector replicated over the mesh, with the
        sharding the fused step returns (so the step compiles once)."""
        from topopt_in_petsc_tpu.parallel.podio import put_blocked

        return put_blocked(np.asarray(value), NamedSharding(self.mesh, REP))

    # -- blocked-layout helpers (host side) ---------------------------- #

    def blocked_elem(self, arr):
        return self._put_blk(
            self.decomp.to_blocked_elem(np.asarray(arr))
        )

    def blocked_nodal(self, arr):
        return self._put_blk(
            self.decomp.to_blocked_nodal(np.asarray(arr))
        )

    def _zeros_blk(self, shape, dtype):
        # device-side zeros: a host np.zeros + put_blocked would copy
        # the full field from the host; a jitted constant costs nothing
        return jax.jit(
            lambda: jnp.zeros(shape, dtype),
            out_shardings=NamedSharding(self.mesh, BLK),
        )()

    def zeros_nodal_blk(self):
        mx, my, mz = self.mesh_shape
        nxl, nyl, nzl = self.decomp.local_nn(0)
        return self._zeros_blk(
            (mx, my, mz, nxl, nyl, nzl, 3),
            jnp.float64 if self.cfg.dtype == "float64"
            else jnp.float32,
        )

    def simp(self, x):
        cfg = self.cfg
        return cfg.Emin + x**cfg.penal * (cfg.Emax - cfg.Emin)

    # -- the shard_mapped physics step --------------------------------- #

    def _physics_local(self, x, u0, rhs, env):
        """Runs INSIDE shard_map on local blocks."""
        cfg = self.cfg
        E = self.simp(x.astype(self.dtype))
        env = self.mg.setup(env, E)
        A = partial(self.mg.apply, 0, env)
        M = self.mg.preconditioner(env)
        dot = make_psum_dot(env[0]["w"], self.cfg.precise_dots)
        res = pcg(
            A, rhs, u0, M,
            rtol=cfg.ksp_rtol, maxiter=cfg.ksp_maxit,
            flexible=True, dot=dot,
        )
        u = res.x
        return (u, res.iters, res.relres) + self._objective_local(x, u, E)

    def _objective_local(self, x, u, E=None):
        """objective / constraints / sensitivities from a solved state
        (the tail of ComputeObjectiveConstraintsSensitivities,
        LinearElasticity.cc:363-445); INSIDE shard_map."""
        cfg = self.cfg
        if E is None:
            E = self.simp(x.astype(self.dtype))
        uKu = element_quadratic_form(u, self.KE_fine)
        acc = jnp.float64 if cfg.precise_dots else self.dtype
        fx = psum_scalar(jnp.sum(E * uKu, dtype=acc)).astype(self.dtype)
        nelem = self.grid.nelem
        vol = psum_scalar(jnp.sum(x, dtype=acc)) / nelem
        gx0 = (vol - cfg.volfrac).astype(self.dtype)
        dfdx = (
            -cfg.penal * x ** (cfg.penal - 1.0) * (cfg.Emax - cfg.Emin)
        ) * uKu
        gx = jnp.concatenate(
            [gx0[None], jnp.zeros((cfg.m - 1,), self.dtype)]
        )
        dgdx = jnp.full((cfg.m, *x.shape), 1.0 / nelem, self.dtype)
        return fx, gx, dfdx, dgdx

    def _build_solve(self):
        env_spec = _spec_like(self.env_blk, BLK)

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(BLK, BLK, BLK, env_spec),
            out_specs=(BLK, REP, REP, REP, REP, BLK, BLK),
            check_vma=False,
        )
        def run(x_blk, u0_blk, rhs_blk, env_blk):
            x = peel(x_blk)
            u0 = peel(u0_blk)
            rhs = peel(rhs_blk)
            env = jax.tree_util.tree_map(peel, env_blk)
            # offsets arrive as (3,) vectors after peel
            u, iters, relres, fx, gx, dfdx, dgdx = self._physics_local(
                x, u0, rhs, env
            )
            return (
                unpeel(u), iters, relres, fx, gx, unpeel(dfdx),
                unpeel(dgdx),
            )

        return jax.jit(run)

    def compute_objective_constraints_sensitivities(self, x_blk, u0_blk):
        """Blocked-layout physics step; returns
        (u_blk, iters, relres, fx, gx, dfdx_blk, dgdx_blk)."""
        return self._solve_sm(x_blk, u0_blk, self.rhs_blk, self.env_blk)


class SpmdOptState(NamedTuple):
    x: jax.Array
    xTilde: jax.Array
    xPhys: jax.Array
    u: jax.Array
    L: jax.Array
    U: jax.Array
    xo1: jax.Array
    xo2: jax.Array
    fscale: jax.Array
    beta: jax.Array  # Heaviside projection sharpness (continuation)
    fx: jax.Array
    gx: jax.Array
    ch: jax.Array
    mnd: jax.Array
    solver_iters: jax.Array
    solver_relres: jax.Array
    u_pde: jax.Array  # PDE-filter warm start (PDEFilter.cc:285); dummy
    # (1,1,1)-block zeros when filter != 2
    pde_viol: jax.Array  # max bound violation of the last PDE-filter
    # apply (Filter.cc:82-97); 0 when filter != 2


def make_spmd_fused_step(cfg: TopOptConfig, mesh: Mesh | None = None):
    """One full optimization iteration as a single SPMD program.

    Returns (step_fn, init_state, engine).  All design-shaped state is in
    blocked element layout; u in blocked nodal layout.
    """
    engine = SpmdElasticity(cfg, mesh)
    decomp = engine.decomp
    dt = engine.dtype
    mesh = engine.mesh
    mesh_shape = engine.mesh_shape

    # regularization: conv kernel + SPMD Hs for types 0/1 (ghost-filled
    # conv of ones), SpmdPDEFilter solves for type 2, passthrough else;
    # projection handled with the traced beta in the state
    conv_local = None
    pdef = None
    if cfg.filter in (0, 1):
        s = filter_stencil_halfwidth(
            cfg.rmin, engine.grid.h, engine.grid.nn
        )
        exl = decomp.local_ne(0)
        if any(s > e for e in exl):
            raise ValueError(
                f"filter stencil halfwidth {s} exceeds local block "
                f"{exl}; use the PDE filter or a larger block"
            )
        kernel_np = build_filter_kernel(cfg.rmin, engine.grid.h, s)
        kernel = jnp.asarray(kernel_np, dt)
        from topopt_in_petsc_tpu.ops.conv_filter import (
            FFT_TAP_THRESHOLD,
            make_fft_conv,
        )

        fft_conv_valid = None
        if (2 * s + 1) ** 3 > FFT_TAP_THRESHOLD:
            ghosted_shape = tuple(e + 2 * s for e in decomp.local_ne(0))
            fft_conv_valid = make_fft_conv(
                ghosted_shape, kernel_np, dt, crop_offset=s
            )

        def conv_local(x, fc):
            # fc: the FFT spectrum pair, threaded through the jit
            # boundary as ARGUMENTS rather than embedded as constants
            # (the 384^3+ local spectra exceed 100 MB)
            g = ghost_fill_elem(x, s, mesh_shape)
            if fft_conv_valid is not None:
                return fft_conv_valid(g, fc)
            out = lax.conv_general_dilated(
                g[None, None], kernel[None, None], (1, 1, 1), "VALID",
                dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
            )
            return out[0, 0]

    elif cfg.filter == 2:
        from topopt_in_petsc_tpu.parallel.spmd_pde_filter import (
            SpmdPDEFilter,
        )

        pdef = SpmdPDEFilter(cfg, decomp, mesh)

    from topopt_in_petsc_tpu.opt.filters import (
        smooth_projection,
        smooth_projection_chainrule,
    )
    projection = bool(cfg.projectionFilter)
    eta = jnp.asarray(cfg.eta, dt)

    mma = MMA(
        engine.grid.nelem, cfg.m, decomp.local_ne(0), dt,
        precise_dots=cfg.precise_dots,
        reduce_sum=lambda v: psum_scalar(
            jnp.sum(v, dtype=jnp.float64 if cfg.precise_dots else dt)
        ),
        reduce_max=lambda v: pmax_scalar(jnp.max(v)),
        reduce_matrix=psum_scalar,
    )

    env_spec = _spec_like(engine.env_blk, BLK)
    pde_env_blk = pdef.env_blk if pdef is not None else {}
    pde_env_spec = _spec_like(pde_env_blk, BLK)
    # FFT filter spectra ride the jit boundary as a replicated-arg
    # pytree (empty when the direct conv / PDE filter is in use)
    fconsts = (
        fft_conv_valid.consts
        if (conv_local is not None and fft_conv_valid is not None)
        else ()
    )
    fconsts_spec = jax.tree_util.tree_map(lambda _: REP, fconsts)
    state_spec = SpmdOptState(
        x=BLK, xTilde=BLK, xPhys=BLK, u=BLK, L=BLK, U=BLK, xo1=BLK,
        xo2=BLK, fscale=REP, beta=REP, fx=REP, gx=REP, ch=REP, mnd=REP,
        solver_iters=REP, solver_relres=REP, u_pde=BLK, pde_viol=REP,
    )

    def core(state: SpmdOptState, rhs_blk, env_blk, pde_env_blk, fc,
             itr):
        conv = (
            (lambda v: conv_local(v, fc))
            if conv_local is not None
            else None
        )
        s_loc = SpmdOptState(
            *[
                peel(v) if spec is BLK else v
                for v, spec in zip(state, state_spec)
            ]
        )
        rhs = peel(rhs_blk)
        env = jax.tree_util.tree_map(peel, env_blk)

        (u, iters, relres, fx, gx, dfdx, dgdx) = engine._physics_local(
            s_loc.xPhys, s_loc.u, rhs, env
        )
        # objective auto-scale at the first iteration (main.cc:68-73)
        fscale = jnp.where(itr == 1, 10.0 / fx, s_loc.fscale).astype(
            s_loc.fscale.dtype
        )
        dfdx = dfdx * fscale

        u_pde = s_loc.u_pde
        pde_viol = jnp.asarray(0.0, dt)
        if pdef is not None:
            pde_env = jax.tree_util.tree_map(peel, pde_env_blk)
            pde_env = pdef._setup_local(pde_env, s_loc.x.shape)

            def pde_apply(field, u0):
                xt, unew, _, _ = pdef._solve_prepared(
                    field, u0, pde_env
                )
                return xt, unew

        Hs = (
            conv(jnp.ones_like(s_loc.x))
            if conv_local is not None
            else None
        )
        if projection:
            dproj = smooth_projection_chainrule(
                s_loc.xTilde, s_loc.beta, eta
            )
            dfdx = dfdx * dproj
            dgdx = dgdx * dproj[None]
        if cfg.filter == 0:
            # sensitivity filter (Filter.cc:167-177)
            dfdx = conv(dfdx * s_loc.x) / Hs / s_loc.x
        elif cfg.filter == 1:
            dfdx = conv(dfdx / Hs)
            dgdx = jnp.stack(
                [conv(dgdx[j] / Hs) for j in range(cfg.m)]
            )
        elif cfg.filter == 2:
            # PDE filter is self-adjoint: gradients are filtered by
            # the same Helmholtz solve (Filter.cc:193-200,
            # PDEFilter.cc:218); one warm-start vector is threaded
            # through all solves like the reference's single U
            dfdx, u_pde = pde_apply(dfdx, u_pde)
            rows = []
            for j in range(cfg.m):
                row, u_pde = pde_apply(dgdx[j], u_pde)
                rows.append(row)
            dgdx = jnp.stack(rows)
        xmin, xmax = mma._movelimit_impl(
            s_loc.x,
            jnp.asarray(cfg.Xmin, dt),
            jnp.asarray(cfg.Xmax, dt),
            jnp.asarray(cfg.movlim, dt),
        )
        x_new, L, U, lam, y, z = mma._update_impl(
            s_loc.x, dfdx, gx, dgdx, xmin, xmax,
            s_loc.L, s_loc.U, s_loc.xo1, s_loc.xo2,
            itr <= 2,
        )
        ch = pmax_scalar(jnp.max(jnp.abs(x_new - s_loc.x)))
        if cfg.filter == 1:
            xTilde = conv(x_new) / Hs
        elif cfg.filter == 2:
            xt_raw, u_pde = pde_apply(x_new, u_pde)
            # bound-violation clip (Filter.cc:76-101); the max
            # violation is reported for the host to warn on
            pde_viol = pmax_scalar(
                jnp.maximum(jnp.max(-xt_raw), jnp.max(xt_raw - 1.0))
            ).astype(dt)
            xTilde = jnp.clip(xt_raw, 0.0, 1.0)
        else:
            xTilde = x_new
        if projection:
            xPhys = smooth_projection(xTilde, s_loc.beta, eta)
        else:
            xPhys = xTilde
        nelem = engine.grid.nelem
        mnd = psum_scalar(
            jnp.sum(4.0 * xPhys * (1.0 - xPhys))
        ) / nelem
        return SpmdOptState(
            x=x_new, xTilde=xTilde, xPhys=xPhys, u=u, L=L, U=U,
            xo1=s_loc.x, xo2=s_loc.xo1, fscale=fscale,
            beta=s_loc.beta, fx=fx,
            gx=gx, ch=ch, mnd=mnd, solver_iters=iters,
            solver_relres=relres, u_pde=u_pde, pde_viol=pde_viol,
        )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_spec, BLK, env_spec, pde_env_spec,
                  fconsts_spec, REP),
        out_specs=state_spec,
        check_vma=False,
    )
    def step(state, rhs_blk, env_blk, pde_env_blk, fc, itr):
        out = core(state, rhs_blk, env_blk, pde_env_blk, fc, itr)
        return SpmdOptState(
            *[
                unpeel(v) if spec is BLK else v
                for v, spec in zip(out, state_spec)
            ]
        )

    # one compiled program for every iteration: `itr` is traced and
    # carries the reference's k<3 asymptote logic (GenSub,
    # MMA.cc:532-537) and the itr==1 objective scale; rhs/env flow as jit
    # arguments (no large-array closures)
    _step = jax.jit(step)

    # standalone FilterProject over the SPMD blocks (main.cc:48-52's
    # pre-loop filter and the beta-continuation re-projection): same
    # filter tail as the fused step, without physics/MMA
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(BLK, REP, BLK, pde_env_spec, fconsts_spec),
        out_specs=(BLK, BLK, BLK),
        check_vma=False,
    )
    def _filter_project(x_blk, beta, u_pde_blk, pde_env_blk, fc):
        x = peel(x_blk)
        u_pde = peel(u_pde_blk)
        if cfg.filter == 1:
            Hs = conv_local(jnp.ones_like(x), fc)
            xTilde = conv_local(x, fc) / Hs
        elif cfg.filter == 2:
            pde_env = jax.tree_util.tree_map(peel, pde_env_blk)
            pde_env = pdef._setup_local(pde_env, x.shape)
            xt_raw, u_pde, _, _ = pdef._solve_prepared(
                x, u_pde, pde_env
            )
            xTilde = jnp.clip(xt_raw, 0.0, 1.0)
        else:  # filter 0 (sensitivity) / passthrough: design unfiltered
            xTilde = x
        if projection:
            xPhys = smooth_projection(xTilde, beta, eta)
        else:
            xPhys = xTilde
        return unpeel(xTilde), unpeel(xPhys), unpeel(u_pde)

    _filter_project_jit = jax.jit(_filter_project)

    def filter_project_blk(x_blk, beta, u_pde_blk):
        return _filter_project_jit(
            x_blk, beta, u_pde_blk, pde_env_blk, fconsts
        )

    engine.filter_project_blk = filter_project_blk

    def step_jit(st: SpmdOptState, itr: int = 3):
        return _step(
            st, engine.rhs_blk, engine.env_blk, pde_env_blk, fconsts,
            jnp.asarray(itr, jnp.int32),
        )

    # initial state
    np_dt = np.float64 if cfg.dtype == "float64" else np.float32
    x0g = np.full(engine.grid.ne, cfg.volfrac, np_dt)
    span = cfg.Xmax - cfg.Xmin
    x0 = engine.blocked_elem(x0g)
    # initial filtered design (main.cc:48): conv preserves the constant
    # volfrac field; projection maps it through the smoothed Heaviside
    xPhys0 = (
        smooth_projection(x0, jnp.asarray(cfg.beta, dt), eta)
        if projection
        else x0
    )
    if pdef is not None:
        u_pde0 = pdef.u_blk
    else:
        mx, my, mz = mesh_shape
        u_pde0 = engine._put_blk(
            np.zeros((mx, my, mz, 1, 1, 1, 1), np_dt)
        )
    init = SpmdOptState(
        x=x0,
        xTilde=x0,
        xPhys=xPhys0,
        u=engine.zeros_nodal_blk(),
        L=engine.blocked_elem(x0g - 0.5 * span),
        U=engine.blocked_elem(x0g + 0.5 * span),
        xo1=x0,
        xo2=x0,
        fscale=jnp.asarray(1.0, dt),
        beta=jnp.asarray(cfg.beta, dt),
        fx=jnp.asarray(0.0, dt),
        gx=jnp.zeros((cfg.m,), dt),
        ch=jnp.asarray(1.0, dt),
        mnd=jnp.asarray(1.0, dt),
        solver_iters=jnp.asarray(0, jnp.int32),
        solver_relres=jnp.asarray(1.0, dt),
        u_pde=u_pde0,
        pde_viol=jnp.asarray(0.0, dt),
    )
    init = SpmdOptState(*[
        v if spec is BLK else engine.put_rep(v)
        for v, spec in zip(init, state_spec)
    ])
    return step_jit, init, engine
