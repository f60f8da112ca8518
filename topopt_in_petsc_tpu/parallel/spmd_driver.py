"""Multi-device optimization driver over the SPMD halo engine.

Runs the main.cc loop with each iteration as ONE SPMD program over the
('x','y','z') device mesh (parallel.spmd_model.make_spmd_fused_step):
the host only advances the loop, logs, and handles VTU/restart cadences
on gathered global arrays.  Selected by the CLI when -mesh_shape is not
1,1,1 (driver.run_topopt).

Covers all filter types: convolution filters (0/1), the Helmholtz PDE
filter (2, SpmdPDEFilter solves fused into the same program), and
passthrough, each with optional Heaviside projection + beta continuation.

"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.io.restart import RestartManager
from topopt_in_petsc_tpu.io.vtu import write_state_vtu
from topopt_in_petsc_tpu.parallel.spmd_model import (
    SpmdOptState,
    make_spmd_fused_step,
)


class SpmdDriver:
    def __init__(self, cfg: TopOptConfig):
        cfg.validate()
        self.cfg = cfg
        print(cfg.banner())
        self.step, self.state, self.engine = make_spmd_fused_step(cfg)
        self.grid = self.engine.grid
        os.makedirs(cfg.workdir, exist_ok=True)
        self.restart_mgr = RestartManager(cfg.workdir, enabled=cfg.restart)
        self.itr = 0
        self.dat = None
        if cfg.output_dat:
            # reference-format parallel output (MPIIO.cc:147-205) on the
            # SPMD path too: the .dat stream IS the reference's parallel
            # output path, so `-fused 1 -output_dat 1` must produce it
            from topopt_in_petsc_tpu.parallel.multihost import is_primary

            if is_primary():
                from topopt_in_petsc_tpu.io.mpiio_dat import MPIIODat

                self.dat = MPIIODat(
                    os.path.join(cfg.workdir, "output_00000.dat"),
                    self.grid,
                )

        if cfg.restart and cfg.restartFileVec:
            data = self.restart_mgr.load(cfg.restartFileVec)
            if data is not None and not cfg.onlyLoadDesign:
                e = self.engine
                self.itr = int(data["itr"])
                self.state = self.state._replace(
                    x=e.blocked_elem(data["x"]),
                    xPhys=e.blocked_elem(data["xPhys"]),
                    xTilde=e.blocked_elem(data["xPhys"]),
                    xo1=e.blocked_elem(data["xo1"]),
                    xo2=e.blocked_elem(data["xo2"]),
                    U=e.blocked_elem(data["U"]),
                    L=e.blocked_elem(data["L"]),
                    fscale=e.put_rep(
                        np.asarray(float(data["fscale"]), e.dtype)
                    ),
                )
                sol = self.restart_mgr.load_state(cfg.restartFileVecSol)
                if sol is not None:
                    self.state = self.state._replace(
                        u=e.blocked_nodal(sol)
                    )
                print(
                    f"# Continue optimization from file: "
                    f"{cfg.restartFileVec}"
                )
            elif data is not None:
                self.state = self.state._replace(
                    x=self.engine.blocked_elem(data["x"])
                )
                print(f"# Loading design from file: {cfg.restartFileVec}")

    # ------------------------------------------------------------- #

    def _scratch(self):
        return os.path.join(self.cfg.workdir, ".podio")

    def _gather_elem(self, blk, tag="f"):
        """ONE blocked element field -> global numpy on the PRIMARY
        process (None elsewhere); COLLECTIVE on multi-host.

        Per-field gathers bound peak host memory to ~1 field instead of
        the whole 8-field state (the round-1 `_globals()` cliff; at
        512^3 each element field is ~0.5 GB on the host).  Pod-safe:
        parallel/podio.py assembles from addressable shards (single
        host) or per-process shard dumps + primary stitch (multi-host,
        the reference's collective MPI-IO role, MPIIO.cc:380-714)."""
        from topopt_in_petsc_tpu.parallel.podio import gather_blocked

        g = gather_blocked(blk, scratch_dir=self._scratch(), tag=tag)
        if g is None:
            return None
        d = self.engine.decomp
        return d.from_blocked_elem(g[..., None])[..., 0]

    def _gather_nodal(self, blk, tag="u"):
        from topopt_in_petsc_tpu.parallel.podio import gather_blocked

        g = gather_blocked(blk, scratch_dir=self._scratch(), tag=tag)
        if g is None:
            return None
        return self.engine.decomp.from_blocked_nodal(g)

    def _write_outputs(self, itr, final=False):
        from topopt_in_petsc_tpu.parallel.multihost import is_primary

        cfg = self.cfg
        # condition must be process-independent (the gathers below are
        # collective): cfg.output_dat, not `self.dat is not None`
        # (the MPIIODat writer object exists only on the primary)
        if not (cfg.output_cadence_vtu or cfg.output_dat):
            return
        s = self.state
        x = self._gather_elem(s.x, "x")
        xTilde = self._gather_elem(s.xTilde, "xTilde")
        xPhys = self._gather_elem(s.xPhys, "xPhys")
        u = self._gather_nodal(s.u, "u")
        if not is_primary():
            return
        if self.dat is not None:
            self.dat.write_fields(
                itr,
                [u[..., 0], u[..., 1], u[..., 2]],
                [x, xTilde, xPhys],
            )
        if cfg.output_cadence_vtu:
            path = os.path.join(cfg.workdir, f"output_{itr:05d}.vtu")
            write_state_vtu(path, self.grid, u, x, xTilde, xPhys)

    def _write_restart(self):
        from topopt_in_petsc_tpu.parallel.multihost import is_primary

        if not self.cfg.restart:
            # process-independent gate: skip the 7-field collective
            # gather entirely when checkpointing is disabled
            return
        s = self.state
        # collective gathers run on EVERY process; only the primary's
        # RestartManager writes (it holds the global arrays, the others
        # get None back)
        fields = (
            self._gather_elem(s.x, "x"),
            self._gather_elem(s.xPhys, "xPhys"),
            self._gather_elem(s.xo1, "xo1"),
            self._gather_elem(s.xo2, "xo2"),
            self._gather_elem(s.U, "U"),
            self._gather_elem(s.L, "L"),
            self._gather_nodal(s.u, "u"),
        )
        if not is_primary():
            return
        self.restart_mgr.write(self.itr, float(s.fscale), *fields)

    # ------------------------------------------------------------- #

    def run(self, max_iters: Optional[int] = None) -> dict:
        cfg = self.cfg
        maxItr = cfg.maxItr if max_iters is None else max_iters
        # STEP 6 (main.cc:48-52): (re-)filter the initial or restarted
        # design with the CURRENT beta before the loop (the reference
        # does not checkpoint beta; a restarted run re-projects with the
        # CLI value, exactly like the interactive Driver)
        s = self.state
        xTilde, xPhys, u_pde = self.engine.filter_project_blk(
            s.x, s.beta, s.u_pde
        )
        self.state = s._replace(
            xTilde=xTilde, xPhys=xPhys, u_pde=u_pde
        )
        history = {"fx": [], "gx": [], "ch": [], "mnd": [], "iters": [],
                   "relres": [], "time": [], "stalled": []}
        ch = 1.0
        while self.itr < maxItr and ch > 0.01:
            self.itr += 1
            t1 = time.perf_counter()
            self.state = self.step(self.state, self.itr)
            jax.block_until_ready(self.state.x)
            t2 = time.perf_counter()

            s = self.state
            fx = float(s.fx)
            fscale = float(s.fscale)
            ch = float(s.ch)
            mnd = float(s.mnd)
            gx0 = float(s.gx[0])

            # beta continuation (main.cc:92-95), host-side scalar update
            changeBeta = False
            if self.cfg.projectionFilter:
                from topopt_in_petsc_tpu.opt.filters import (
                    DesignFilter,
                    smooth_projection,
                )

                beta, changeBeta = DesignFilter.increase_beta(
                    float(s.beta), self.cfg.betaFinal, gx0, self.itr, ch
                )
                # any beta movement (incl. the clamp-to-betaFinal case,
                # which reports changed=False, Filter.cc:281-284)
                # re-projects: reference-exact ordering (main.cc:92-98,
                # IncreaseBeta THEN FilterProject with the NEW beta).
                # xTilde = H x / Hs is beta-independent, so the
                # elementwise re-projection is exact; duplicated halo
                # entries stay consistent.
                if beta != float(s.beta):
                    beta_a = self.engine.put_rep(
                        np.asarray(beta, self.engine.dtype)
                    )
                    xPhys = jax.jit(smooth_projection)(
                        s.xTilde, beta_a,
                        jnp.asarray(self.cfg.eta, self.engine.dtype),
                    )
                    self.state = self.state._replace(
                        beta=beta_a, xPhys=xPhys
                    )
            if self.cfg.filter == 2 and float(s.pde_viol) > 1e-4:
                # bound-violation warning (Filter.cc:82-97)
                print(
                    "BOUND VIOLATION IN PDEFILTER - INCREASE RMIN OR "
                    f"MESH RESOLUTION: xPhys = {float(s.pde_viol):f}"
                )
            print(
                f"State solver:  iter: {int(s.solver_iters)}, "
                f"rerr.: {float(s.solver_relres):e}, time: {t2 - t1:f}"
            )
            stalled = (
                int(s.solver_iters) >= cfg.ksp_maxit
                and float(s.solver_relres) > cfg.ksp_rtol
            )
            if stalled:
                print(
                    f"WARNING: STATE SOLVER DID NOT CONVERGE in "
                    f"{cfg.ksp_maxit} iterations "
                    f"(rerr {float(s.solver_relres):e} > rtol "
                    f"{cfg.ksp_rtol:e}); sensitivities this iteration "
                    f"are unreliable — consider -ksp_type fgmres or "
                    f"more -ksp_maxit"
                )
            print(
                f"It.: {self.itr}, True fx: {fx:f}, "
                f"Scaled fx: {fx * fscale:f}, gx[0]: {gx0:f}, "
                f"ch.: {ch:f}, mnd.: {mnd:f}, time: {t2 - t1:f}"
            )
            history["fx"].append(fx)
            history["gx"].append(gx0)
            history["ch"].append(ch)
            history["mnd"].append(mnd)
            history["iters"].append(int(s.solver_iters))
            history["relres"].append(float(s.solver_relres))
            history["time"].append(t2 - t1)
            history["stalled"].append(stalled)

            if self.itr < 11 or self.itr % 20 == 0 or changeBeta:
                self._write_outputs(self.itr)
            if self.itr % 10 == 0:
                self._write_restart()

        self._write_restart()
        self._write_outputs(self.itr + 1, final=True)
        return history
