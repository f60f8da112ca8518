"""Single-device fused-step optimization driver.

Runs the main.cc loop with each iteration as ONE compiled XLA program
(`parallel/fused_step.make_fused_step`).  The host only advances the
loop, applies beta continuation (with reference-exact re-projection,
main.cc:92-98), logs, and handles the VTU/restart cadences.

Selected by the CLI for `-fused 1` on a 1,1,1 mesh with filter 0/1
(driver.run_topopt); multi-device and PDE-filter runs use
parallel/spmd_driver.SpmdDriver.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.io.restart import RestartManager
from topopt_in_petsc_tpu.io.vtu import write_state_vtu
from topopt_in_petsc_tpu.parallel.fused_step import make_fused_step


class FusedDriver:
    def __init__(self, cfg: TopOptConfig):
        cfg.validate()
        self.cfg = cfg
        print(cfg.banner())
        self.step, self.state, aux = make_fused_step(
            cfg, return_aux=True
        )
        self.grid = aux["grid"]
        self.filt = aux["filt"]
        self._filt_consts = aux["filt_consts"]
        self.dtype = cfg.jnp_dtype
        # beta continuation re-filters/projects the design with the NEW
        # beta before the next solve (main.cc:92-98 ordering)
        self._reproject = jax.jit(
            partial(
                self.filt._project_impl,
                projection=bool(cfg.projectionFilter),
            )
        )
        os.makedirs(cfg.workdir, exist_ok=True)
        self.restart_mgr = RestartManager(cfg.workdir, enabled=cfg.restart)
        self.itr = 0
        self.dat = None
        if cfg.output_dat:
            from topopt_in_petsc_tpu.io.mpiio_dat import MPIIODat

            self.dat = MPIIODat(
                os.path.join(cfg.workdir, "output_00000.dat"), self.grid
            )

        if cfg.restart and cfg.restartFileVec:
            data = self.restart_mgr.load(cfg.restartFileVec)
            dt = self.dtype
            if data is not None and not cfg.onlyLoadDesign:
                self.itr = int(data["itr"])
                self.state = self.state._replace(
                    x=jnp.asarray(data["x"], dt),
                    xPhys=jnp.asarray(data["xPhys"], dt),
                    xTilde=jnp.asarray(data["xPhys"], dt),
                    xo1=jnp.asarray(data["xo1"], dt),
                    xo2=jnp.asarray(data["xo2"], dt),
                    U=jnp.asarray(data["U"], dt),
                    L=jnp.asarray(data["L"], dt),
                    fscale=jnp.asarray(float(data["fscale"]), dt),
                )
                sol = self.restart_mgr.load_state(cfg.restartFileVecSol)
                if sol is not None:
                    self.state = self.state._replace(
                        u=jnp.asarray(sol, dt)
                    )
                print(
                    f"# Continue optimization from file: "
                    f"{cfg.restartFileVec}"
                )
            elif data is not None:
                self.state = self.state._replace(
                    x=jnp.asarray(data["x"], dt)
                )
                print(f"# Loading design from file: {cfg.restartFileVec}")

    # ------------------------------------------------------------- #

    def _write_outputs(self, itr):
        cfg = self.cfg
        s = self.state
        if self.dat is None and not cfg.output_cadence_vtu:
            return
        u = s.u
        if self.dat is not None:
            un = np.asarray(u)
            self.dat.write_fields(
                itr,
                [un[..., 0], un[..., 1], un[..., 2]],
                [np.asarray(s.x), np.asarray(s.xTilde),
                 np.asarray(s.xPhys)],
            )
        if cfg.output_cadence_vtu:
            path = os.path.join(cfg.workdir, f"output_{itr:05d}.vtu")
            write_state_vtu(
                path, self.grid, u, s.x, s.xTilde, s.xPhys
            )

    def _write_restart(self):
        if not self.restart_mgr.enabled:
            # skip the device-to-host copies below too
            return
        s = self.state
        self.restart_mgr.write(
            self.itr, float(s.fscale),
            np.asarray(s.x), np.asarray(s.xPhys),
            np.asarray(s.xo1), np.asarray(s.xo2),
            np.asarray(s.U), np.asarray(s.L),
            np.asarray(s.u),
        )

    # ------------------------------------------------------------- #

    def run(self, max_iters: Optional[int] = None) -> dict:
        cfg = self.cfg
        maxItr = cfg.maxItr if max_iters is None else max_iters
        # STEP 6 (main.cc:48-52): (re-)filter the initial or restarted
        # design with the CURRENT beta before the loop — the reference
        # does not checkpoint beta, so a restarted run re-projects with
        # the CLI value (exactly like the interactive Driver)
        s = self.state
        xTilde, xPhys = self._reproject(
            s.x, s.beta, jnp.asarray(cfg.eta, self.dtype),
            *self._filt_consts,
        )
        self.state = s._replace(xTilde=xTilde, xPhys=xPhys)
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

            # beta continuation + reference-exact re-projection
            # (main.cc:92-98: IncreaseBeta THEN FilterProject)
            changeBeta = False
            if cfg.projectionFilter:
                from topopt_in_petsc_tpu.opt.filters import DesignFilter

                beta, changeBeta = DesignFilter.increase_beta(
                    float(s.beta), cfg.betaFinal, gx0, self.itr, ch
                )
                # changeBeta only gates the VTU cadence (main.cc:114);
                # the clamp-to-betaFinal case moves beta with
                # changed=False (Filter.cc:281-284) and must still
                # re-project
                if beta != float(s.beta):
                    beta_a = jnp.asarray(beta, self.dtype)
                    xTilde, xPhys = self._reproject(
                        s.x, beta_a, jnp.asarray(cfg.eta, self.dtype),
                        *self._filt_consts,
                    )
                    mnd = float(jnp.mean(4.0 * xPhys * (1.0 - xPhys)))
                    self.state = self.state._replace(
                        beta=beta_a, xTilde=xTilde, xPhys=xPhys,
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
        self._write_outputs(self.itr + 1)
        return history
