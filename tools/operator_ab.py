"""A/B timing of the fine-level operator forms on one GPU.

    python tools/operator_ab.py [--sizes 128,256] [--reps 3]

For each size (elements per axis) and each form (`-operator_impl xla`,
the XLA gather form, and `auto`, the fused kernel), in one process: the
state solve of the split driver and the steady-state fused optimization
iteration (itr >= 3), each timed with `block_until_ready` after
warm-up; compilation is reported separately as set-up.  Prints one line per measurement and,
last, a JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _cfg(ne, impl, nlvls):
    from topopt_in_petsc_tpu.config import TopOptConfig

    n = ne + 1
    cfg = TopOptConfig(nx=n, ny=n, nz=n, nlvls=nlvls, operator_impl=impl,
                       restart=False, output_cadence_vtu=False)
    cfg.validate()
    return cfg


def time_solve(ne, impl, nlvls, reps):
    import jax
    import jax.numpy as jnp

    from topopt_in_petsc_tpu.models.elasticity import LinearElasticity

    cfg = _cfg(ne, impl, nlvls)
    phys = LinearElasticity(cfg)
    x = jnp.full(phys.grid.ne, cfg.volfrac, jnp.float32)
    t0 = time.perf_counter()
    res = phys.solve_state(x)
    jax.block_until_ready(res.x)
    setup = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = phys.solve_state(x)  # cold start: zero warm start each time
        jax.block_until_ready(res.x)
        ts.append(time.perf_counter() - t0)
    return {"s": statistics.median(ts), "all": ts, "setup_s": setup,
            "iters": int(res.iters), "relres": float(res.relres)}


def time_fused(ne, impl, nlvls, reps):
    import jax

    from topopt_in_petsc_tpu.parallel.fused_step import make_fused_step

    cfg = _cfg(ne, impl, nlvls)
    step, s = make_fused_step(cfg)
    t0 = time.perf_counter()
    for itr in (1, 2, 3):  # compilation and the first iterations
        s = step(s, itr)
        jax.block_until_ready(s.x)
    setup = time.perf_counter() - t0
    ts, iters = [], []
    for itr in range(4, 4 + reps):
        t0 = time.perf_counter()
        s = step(s, itr)
        jax.block_until_ready(s.x)
        ts.append(time.perf_counter() - t0)
        iters.append(int(s.solver_iters))
    return {"s": statistics.median(ts), "all": ts, "setup_s": setup,
            "solver_iters": iters, "fx": float(s.fx)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="128,256")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    from topopt_in_petsc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"needs a GPU, JAX found {d.platform}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"# {d.device_kind}; nvidia-smi: {card}", flush=True)
    out = {"device_kind": d.device_kind, "card": card, "results": []}
    for ne in (int(v) for v in args.sizes.split(",")):
        nlvls = 5 if ne >= 256 else 4
        for what, fn in (("solve", time_solve), ("fused_iter", time_fused)):
            for impl in ("xla", "auto"):
                r = fn(ne, impl, nlvls, args.reps)
                r.update(size=ne, what=what, impl=impl)
                out["results"].append(r)
                print(f"{what} {ne}^3 {impl}: {r['s']:.4f} s (median of "
                      f"{args.reps}; set-up {r['setup_s']:.1f} s) "
                      f"{ {k: r[k] for k in r if k in ('iters', 'relres', 'solver_iters', 'fx')} }",
                      flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
