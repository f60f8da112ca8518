"""Benchmark harness — run on one NVIDIA GPU.

Primary metric (stdout, ONE json line): effective SpMV throughput of the
matrix-free elasticity operator at 256^3 elements, in nnz/s.  "Effective
nnz" counts the nonzeros the reference's assembled BAIJ matrix would hold:
27 node-couplings per node x 3x3 block entries = 243 nnz per node, i.e.
81 * ndof with ndof = 3 * nnodes (SURVEY §6 / BASELINE.md).  NOTE:
rounds 1-3 reported 3x this (27*9*ndof = 729/node, double-counting the
dof factor); all pre-round-4 Gnnz/s figures divide by 3 to compare.

vs_baseline: ratio against the reference's estimated per-core CPU SpMV
throughput of 5.0e8 nnz/s (a PETSc BAIJ SpMV streams ~12 bytes/nnz; at
~6 GB/s effective per-core memory bandwidth that is ~5e8 nnz/s — the repo
publishes no numbers, BASELINE.md requires an estimate to be stated).
Target from BASELINE.md: vs_baseline >= 2.

Extra diagnostics (stderr): MG-PCG solve DOF/s and wall-clock per full
optimization iteration at 128^3.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

PER_CORE_CPU_NNZ_S = 5.0e8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class StageTimeout(Exception):
    pass


@contextlib.contextmanager
def stage_timeout(seconds: int):
    """SIGALRM guard so one slow compile can't eat the whole bench."""

    def handler(signum, frame):
        raise StageTimeout()

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _time_fn(fn, *args, reps=20, warmup=3):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def bench_spmv(nelem_axis: int) -> float:
    """Masked K@u at nelem_axis^3 elements with the operator the solver
    uses on this platform (ops/select.py); returns seconds per matvec."""
    from topopt_in_petsc_tpu.grid import Grid
    from topopt_in_petsc_tpu.models.elasticity import build_cantilever_bc
    from topopt_in_petsc_tpu.models.elements import hex8_stiffness
    from topopt_in_petsc_tpu.ops.hex_operator import apply_hex_operator
    from topopt_in_petsc_tpu.ops.select import (
        make_fine_apply,
        resolve_operator,
    )

    n = nelem_axis + 1
    grid = Grid(nn=(n, n, n), lo=(0, 0, 0), hi=(2, 1, 1))
    KE_np = hex8_stiffness(*grid.h, 0.3)
    KE = jnp.asarray(KE_np, jnp.float32)
    N_np, _ = build_cantilever_bc(grid, dtype=np.float32)
    N = jnp.asarray(N_np)

    key = jax.random.PRNGKey(0)
    E = jax.random.uniform(
        key, grid.ne, dtype=jnp.float32, minval=1e-9, maxval=1.0
    )
    u = jax.random.normal(
        jax.random.PRNGKey(1), (*grid.nn, 3), dtype=jnp.float32
    )
    impl = resolve_operator("auto", "float32")
    fine = make_fine_apply(impl, KE_np) or (
        lambda v, E: apply_hex_operator(v, E, KE)
    )

    @jax.jit
    def A(v, E, N):
        Kv = fine(N * v, E)
        return N * Kv + (1.0 - N) * v

    dt = _time_fn(A, u, E, N)
    return dt, grid, impl


def bench_solve(nelem_axis: int, nlvls: int = 4):
    """Full MG-PCG state solve at nelem_axis^3 elements."""
    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.models.elasticity import LinearElasticity

    n = nelem_axis + 1
    cfg = TopOptConfig(
        nx=n, ny=n, nz=n, nlvls=nlvls, dtype="float32",
        precise_dots=False, ksp_maxit=200,
    )
    cfg.validate()
    phys = LinearElasticity(cfg)
    x = jnp.full(phys.grid.ne, cfg.volfrac, dtype=jnp.float32)

    # solve_state DONATES the warm-start buffer: fresh zeros per call
    res = phys.solve_state(x)  # compile + first solve
    jax.block_until_ready(res.x)
    t0 = time.perf_counter()
    res = phys.solve_state(x)
    jax.block_until_ready(res.x)
    dt = time.perf_counter() - t0
    return dt, int(res.iters), float(res.relres), cfg


def setup_512(ne: int = 512, nlvls: int = 6):
    """Build the 512^3 problem (compile happens on the first solve)."""
    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.models.elasticity import LinearElasticity

    cfg = TopOptConfig(
        nx=ne + 1, ny=ne + 1, nz=ne + 1, nlvls=nlvls, dtype="float32",
        precise_dots=False, ksp_maxit=400,
    )
    cfg.validate()
    phys = LinearElasticity(cfg)
    x = jnp.full(phys.grid.ne, cfg.volfrac, dtype=jnp.float32)
    return phys, x, cfg


def warm_512(phys, x):
    """Compile + first solve, in its OWN stage/timeout so a slow cold
    compile degrades to a reported warm-up failure instead of eating the
    measured stage."""
    res = phys.solve_state(x)
    jax.block_until_ready(res.x)
    return int(res.iters)


def measure_512(phys, x):
    """Timed 512^3 (405M dof) state solve."""
    t0 = time.perf_counter()
    res = phys.solve_state(x)
    jax.block_until_ready(res.x)
    dt = time.perf_counter() - t0
    return dt, int(res.iters), float(res.relres)


def bench_opt_iter(nelem_axis: int, nlvls: int = 4, **cfg_kw):
    """One fused optimization iteration (solve+filter+MMA)."""
    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.parallel.fused_step import make_fused_step

    n = nelem_axis + 1
    cfg = TopOptConfig(
        nx=n, ny=n, nz=n, nlvls=nlvls, dtype="float32",
        precise_dots=False,
        **{"ksp_maxit": 200, **cfg_kw},
    )
    step, state = make_fused_step(cfg)
    # honest driver semantics: itr 1 (fscale + fresh asymptotes) and
    # itr 2 (fresh asymptotes) run first, a STEADY-STATE iteration
    # (itr >= 3) is what gets timed
    s = step(state, 1)  # compile + iteration 1
    jax.block_until_ready(s.x)
    s = step(s, 2)
    jax.block_until_ready(s.x)
    s = step(s, 3)
    jax.block_until_ready(s.x)
    t0 = time.perf_counter()
    s2 = step(s, 4)
    jax.block_until_ready(s2.x)
    return time.perf_counter() - t0, s2


def emit(value, vs_baseline, metric, stages):
    """The contract: exactly ONE json line on stdout, ALWAYS — a missing
    GPU reports as status fields, never a stack trace."""
    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": "nnz/s",
                "vs_baseline": vs_baseline,
                "stages": stages,
            }
        )
    )


def main():
    stages: dict = {}

    # BENCH_SMOKE=1: identical code paths at tiny sizes
    smoke = bool(os.environ.get("BENCH_SMOKE"))
    spmv_trials = (16,) if smoke else (256, 128)
    solve_ne = 16 if smoke else 128
    opt1 = (16, 2) if smoke else (128, 4)
    opt2 = (16, 2) if smoke else (256, 5)
    solve2_ne, solve2_nlvls = (16, 2) if smoke else (256, 5)
    big_ne, big_nlvls = (32, 2) if smoke else (512, 6)

    # --- backend probe: a measurement with no GPU must fail ---
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    stages["backend"] = {
        "ok": dev.platform == "gpu", "platform": dev.platform,
        "kind": dev.device_kind, "count": len(jax.devices()),
    }
    if dev.platform != "gpu":
        stages["backend"]["error"] = f"no GPU: JAX found {dev.platform}"
        emit(None, None, "elasticity_spmv_nnz_per_s", stages)
        return 1

    # --- primary: SpMV nnz/s at 256^3 (fallback 128^3) ---
    nnz_s = None
    metric = "elasticity_spmv_nnz_per_s"  # suffixed on success only
    for ne in spmv_trials:
        try:
            with stage_timeout(900):
                dt, grid, impl = bench_spmv(ne)
            log(f"spmv impl={impl}")
            ndof = 3 * grid.nnode
            # 243 nnz/node = 81 nnz per scalar dof-row (27 node-
            # couplings x 3x3 blocks); rounds 1-3 inflated this 3x
            nnz_s = 81 * ndof / dt
            log(
                f"spmv {ne}^3: {dt * 1e3:.3f} ms/matvec, ndof={ndof:,},"
                f" eff {nnz_s / 1e9:.2f} Gnnz/s"
            )
            stages["spmv"] = {
                "ok": True, "size": ne, "impl": impl,
                "ms_per_matvec": dt * 1e3, "gnnz_s": nnz_s / 1e9,
            }
            metric = f"elasticity_spmv_nnz_per_s_{ne}^3"
            break
        except (StageTimeout, Exception) as e:  # noqa: BLE001
            log(f"spmv@{ne}^3 failed: {type(e).__name__}: {e}")
            stages["spmv"] = {
                "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
            }

    # --- diagnostics: MG-PCG solve + full opt iteration at 128^3 ---
    try:
        with stage_timeout(900):
            sdt, iters, relres, cfg = bench_solve(solve_ne)
        dof_s = cfg.ndof * max(iters, 1) / sdt
        log(
            f"solve {solve_ne}^3: {sdt:.3f} s, iters={iters}, "
            f"relres={relres:.2e}, PCG {dof_s / 1e6:.1f} Mdof*iter/s"
        )
        stages["solve_128"] = {
            "ok": True, "s": sdt, "iters": iters, "relres": relres,
        }
    except (StageTimeout, Exception) as e:  # noqa: BLE001
        log(f"solve bench failed: {type(e).__name__}: {e}")
        stages["solve_128"] = {
            "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
        }

    try:
        with stage_timeout(900):
            it_dt, s2 = bench_opt_iter(*opt1)
        log(
            f"opt-iter {opt1[0]}^3: {it_dt:.3f} s/iteration "
            f"(solver_iters={int(s2.solver_iters)}, fx={float(s2.fx):.4f})"
        )
        stages["opt_iter_128"] = {
            "ok": True, "s_per_iter": it_dt,
            "solver_iters": int(s2.solver_iters),
        }
    except (StageTimeout, Exception) as e:  # noqa: BLE001
        log(f"opt-iter bench failed: {type(e).__name__}: {e}")
        stages["opt_iter_128"] = {
            "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
        }

    # BASELINE.md config #4: wall-clock per opt iteration at 256^3
    # (fused single-program step, 5-level MG, one device)
    try:
        with stage_timeout(1200):
            it_dt, s2 = bench_opt_iter(opt2[0], nlvls=opt2[1])
        log(
            f"opt-iter {opt2[0]}^3 (fused): {it_dt:.3f} s/iteration "
            f"(solver_iters={int(s2.solver_iters)}, fx={float(s2.fx):.4f})"
        )
        stages["opt_iter_256"] = {
            "ok": True, "s_per_iter": it_dt,
            "solver_iters": int(s2.solver_iters),
        }
    except (StageTimeout, Exception) as e:  # noqa: BLE001
        log(f"opt-iter 256^3 bench failed: {type(e).__name__}: {e}")
        stages["opt_iter_256"] = {
            "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
        }

    s2 = None  # release the 256^3 OptState before the 512^3 stage

    # standalone 256^3 MG-PCG state solve
    try:
        with stage_timeout(1200):
            sdt, iters, relres, cfg = bench_solve(
                solve2_ne, nlvls=solve2_nlvls
            )
        log(
            f"solve {solve2_ne}^3: {sdt:.3f} s, iters={iters}, "
            f"relres={relres:.2e}, PCG "
            f"{cfg.ndof * max(iters, 1) / sdt / 1e6:.0f} Mdof*iter/s"
        )
        stages["solve_256"] = {
            "ok": True, "s": sdt, "iters": iters, "relres": relres,
        }
    except (StageTimeout, Exception) as e:  # noqa: BLE001
        log(f"solve 256^3 bench failed: {type(e).__name__}: {e}")
        stages["solve_256"] = {
            "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
        }

    # BASELINE.md config #5's single-device leg: 512^3 (405M dof) solve,
    # split warm-up (compile-heavy, own generous budget) / measure
    phys5 = None
    try:
        with stage_timeout(60):
            phys5, x5, cfg5 = setup_512(big_ne, big_nlvls)
        with stage_timeout(3000):
            t0 = time.perf_counter()
            warm_iters = warm_512(phys5, x5)
            log(
                f"512^3 warm-up (compile + first solve): "
                f"{time.perf_counter() - t0:.1f} s, iters={warm_iters}"
            )
        stages["warm_512"] = {"ok": True, "iters": warm_iters}
    except (StageTimeout, Exception) as e:  # noqa: BLE001
        log(f"512^3 warm-up failed: {type(e).__name__}: {e}")
        stages["warm_512"] = {
            "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
        }
        phys5 = None
    if phys5 is not None:
        try:
            with stage_timeout(900):
                sdt, iters, relres = measure_512(phys5, x5)
            log(
                f"solve 512^3 (405M dof, one device): {sdt:.1f} s, "
                f"iters={iters}, relres={relres:.2e}, PCG "
                f"{cfg5.ndof * max(iters, 1) / sdt / 1e6:.0f} Mdof*iter/s"
            )
            stages["solve_512"] = {
                "ok": True, "s": sdt, "iters": iters, "relres": relres,
            }
        except (StageTimeout, Exception) as e:  # noqa: BLE001
            log(f"solve 512^3 bench failed: {type(e).__name__}: {e}")
            stages["solve_512"] = {
                "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
            }

    phys5 = x5 = None  # release the 512^3 solver before the fused stage

    # the giga-dof FULL optimization iteration (solve + filter + MMA at
    # 405M dof on one device).  Own stage so a failure degrades to an
    # honest red row instead of eating the run.
    if os.environ.get("BENCH_SKIP_FUSED512"):
        stages["opt_iter_512"] = {"ok": False, "error": "skipped"}
    else:
        try:
            with stage_timeout(4200):
                it_dt, s2 = bench_opt_iter(
                    big_ne, nlvls=big_nlvls, ksp_maxit=400,
                )
            log(
                f"opt-iter {big_ne}^3 (fused): {it_dt:.1f} "
                f"s/iteration (solver_iters={int(s2.solver_iters)}, "
                f"fx={float(s2.fx):.4f})"
            )
            stages["opt_iter_512"] = {
                "ok": True, "s_per_iter": it_dt,
                "solver_iters": int(s2.solver_iters),
            }
        except (StageTimeout, Exception) as e:  # noqa: BLE001
            log(f"opt-iter 512^3 bench failed: {type(e).__name__}: {e}")
            stages["opt_iter_512"] = {
                "ok": False, "error": f"{type(e).__name__}: {e}"[:300],
            }
        s2 = None

    emit(
        nnz_s,
        None if nnz_s is None else nnz_s / PER_CORE_CPU_NNZ_S,
        metric,
        stages,
    )
    # a failed stage is reported in the JSON line AND in the exit code
    failed = [k for k, v in stages.items()
              if not v["ok"] and v.get("error") != "skipped"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
