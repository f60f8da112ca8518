"""One fully-fused optimization iteration as a single jitted function.

This is the whole per-iteration pipeline of main.cc:54-123 — state solve,
objective/sensitivities, filter chain rule, movelimits, MMA dual solve,
design filtering — traced into ONE XLA program, so a sharded invocation
partitions every stage over the same device mesh with no host round-trips.
The interactive Driver keeps stages separate for logging/cadence control;
this fused step is the production hot loop and the multi-device
compile-validation path (`__graft_entry__.dryrun_multichip`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elasticity import LinearElasticity
from topopt_in_petsc_tpu.opt.filters import DesignFilter
from topopt_in_petsc_tpu.opt.mma import MMA


class OptState(NamedTuple):
    x: jax.Array  # design
    xTilde: jax.Array  # filtered design
    xPhys: jax.Array  # physical design
    u: jax.Array  # state field (warm start)
    L: jax.Array  # MMA lower asymptotes
    U: jax.Array  # MMA upper asymptotes
    xo1: jax.Array  # design history k-1
    xo2: jax.Array  # design history k-2
    fscale: jax.Array  # objective scale
    beta: jax.Array  # Heaviside projection sharpness (continuation)
    fx: jax.Array  # last compliance
    gx: jax.Array  # last constraints
    ch: jax.Array  # last design change
    mnd: jax.Array  # measure of non-discreteness (Filter.cc:206-225)
    solver_iters: jax.Array
    solver_relres: jax.Array


def make_fused_step(cfg: TopOptConfig, mesh=None, return_aux: bool = False):
    """Returns (step_fn, init_state), or (step_fn, init_state, aux) with
    aux = {grid, physics, filt, filt_consts} when return_aux=True (the
    FusedDriver needs the filter for host-side beta re-projection).
    step_fn: (OptState, itr) -> OptState.

    `itr` (1-based, like main.cc:54's counter) is a traced argument of
    one compiled program and carries the reference's first-iteration
    semantics: itr == 1 sets fscale = 10/fx (main.cc:68-73), itr <= 2
    uses fresh asymptotes (GenSub k<3, MMA.cc:532-537).  This keeps
    fused-step trajectories identical to the interactive Driver's from
    iteration 1.

    If `mesh` is given, init_state arrays are device_put with the canonical
    GSPMD shardings (element fields P('x','y','z'), nodal replicated).
    NOTE: the GSPMD path is a compile-validation convenience, not the
    scaling path — nodal fields have odd extents and replicate at jit
    boundaries, so only element-field work actually shards.  Production
    multi-device scaling is the shard_map engine (parallel/spmd_model.py).
    """
    cfg.validate()
    grid = Grid.from_config(cfg)
    physics = LinearElasticity(cfg, grid)
    filt = DesignFilter(cfg, grid)
    mma = MMA(
        grid.nelem, cfg.m, grid.ne, cfg.jnp_dtype,
        precise_dots=cfg.precise_dots,
    )
    dt = cfg.jnp_dtype
    eta = jnp.asarray(cfg.eta, dt)
    projection = bool(cfg.projectionFilter)

    rhs = physics.RHS
    masks = physics.mask_args()
    filt_consts = (filt.Hs, filt._fft_consts)

    # rhs/masks/filter constants flow as jit arguments (large-array
    # closures would be embedded in the program as constants)

    def step(s: OptState, rhs, masks, filt_consts, itr) -> OptState:
        res = physics._solve_impl(s.xPhys, s.u, rhs, masks)
        u = res.x
        fx, gx, dfdx, dgdx = physics._objective_parts(
            s.xPhys.astype(physics.dtype), u
        )
        # objective auto-scale at the first iteration (main.cc:68-73)
        fscale = jnp.where(itr == 1, 10.0 / fx, s.fscale).astype(dt)
        dfdx = dfdx * fscale
        dfdx, dgdx = filt._gradients_impl(
            s.x, s.xTilde, dfdx, dgdx, s.beta, eta, *filt_consts,
            projection=projection,
        )
        # movelimits + MMA dual solve + design filter/projection
        xmin, xmax = mma._movelimit_impl(
            s.x,
            jnp.asarray(cfg.Xmin, dt),
            jnp.asarray(cfg.Xmax, dt),
            jnp.asarray(cfg.movlim, dt),
        )
        x_new, L, U, lam, y, z = mma._update_impl(
            s.x, dfdx, gx, dgdx, xmin, xmax,
            s.L, s.U, s.xo1, s.xo2,
            itr <= 2,
        )
        ch = jnp.max(jnp.abs(x_new - s.x))
        xTilde, xPhys = filt._project_impl(
            x_new, s.beta, eta, *filt_consts, projection=projection,
        )
        mnd = jnp.mean(4.0 * xPhys * (1.0 - xPhys))
        return OptState(
            x=x_new, xTilde=xTilde, xPhys=xPhys, u=u,
            L=L, U=U, xo1=s.x, xo2=s.xo1,
            fscale=fscale, beta=s.beta, fx=fx, gx=gx, ch=ch, mnd=mnd,
            solver_iters=res.iters, solver_relres=res.relres,
        )

    x0 = jnp.full(grid.ne, cfg.volfrac, dtype=dt)
    u0 = jnp.zeros((*grid.nn, 3), dtype=dt)
    # pre-populated asymptotes (the fused step always runs the adaptive
    # k>2 branch; the Driver handles the first two iterations)
    span = cfg.Xmax - cfg.Xmin
    # init design goes through the same filter+projection as the
    # Driver's STEP 6 (main.cc:50-52 FilterProject before the loop)
    xt0, xp0 = jax.jit(
        partial(filt._project_impl, projection=projection)
    )(x0, jnp.asarray(cfg.beta, dt), eta, *filt_consts)
    init = OptState(
        x=x0,
        xTilde=xt0,
        xPhys=xp0,
        u=u0,
        L=x0 - 0.5 * span,
        U=x0 + 0.5 * span,
        xo1=x0,
        xo2=x0,
        fscale=jnp.asarray(1.0, dt),
        beta=jnp.asarray(cfg.beta, dt),
        fx=jnp.asarray(0.0, dt),
        gx=jnp.zeros((cfg.m,), dt),
        ch=jnp.asarray(1.0, dt),
        mnd=jnp.asarray(1.0, dt),
        solver_iters=jnp.asarray(0, jnp.int32),
        solver_relres=jnp.asarray(0.0, jnp.float64
                                  if cfg.precise_dots else dt),
    )

    if mesh is not None:
        from topopt_in_petsc_tpu.parallel.mesh import (
            elem_sharding,
            node_sharding,
            replicated,
        )

        es, ns, rs = elem_sharding(mesh), node_sharding(mesh), replicated(
            mesh
        )
        shardings = OptState(
            x=es, xTilde=es, xPhys=es, u=ns, L=es, U=es, xo1=es, xo2=es,
            fscale=rs, beta=rs, fx=rs, gx=rs, ch=rs, mnd=rs,
            solver_iters=rs, solver_relres=rs,
        )
        init = jax.tree_util.tree_map(jax.device_put, init, shardings)
        rhs = jax.device_put(rhs, ns)
        masks = [jax.device_put(m, rs) for m in masks]
        mask_shardings = [rs for _ in masks]
        fc_shardings = jax.tree_util.tree_map(
            lambda _: rs, filt_consts
        )
        filt_consts = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, rs), filt_consts
        )
        inner = jax.jit(
            step,
            in_shardings=(shardings, ns, mask_shardings, fc_shardings,
                          rs),
            out_shardings=shardings,
        )
    else:
        inner = jax.jit(step)

    def step_jit(s: OptState, itr: int = 3) -> OptState:
        return inner(s, rhs, masks, filt_consts,
                     jnp.asarray(itr, jnp.int32))

    if return_aux:
        aux = {
            "grid": grid,
            "physics": physics,
            "filt": filt,
            "filt_consts": filt_consts,
        }
        return step_jit, init, aux
    return step_jit, init
