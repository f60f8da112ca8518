"""CLI entry point: `python -m topopt_in_petsc_tpu -nx 65 -ny 33 -nz 33 ...`

Accepts the reference's PETSc-style single-dash flags (TopOpt.cc:154-165,
323-337) — run the default cantilever with no arguments, like
`mpirun -np 4 ./topopt` runs the reference's default.
"""

import sys

import jax

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.driver import run_topopt


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # f64 scalar reductions on top of f32 fields (like the reference's
    # all-f64 PETSc arithmetic where it matters for convergence).
    jax.config.update("jax_enable_x64", True)
    from topopt_in_petsc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # multi-process launch (the reference's `mpirun -np N`, README.md:29):
    # each process runs this same CLI; initialize() joins the job named
    # by JAX's coordinator variables (no-op for one process).
    from topopt_in_petsc_tpu.parallel.multihost import initialize

    initialize()
    cfg = TopOptConfig.from_args(argv)
    history = run_topopt(cfg)
    # per-iteration trajectory artifact (fx/gx/ch/mnd/solver iters/s per
    # iteration) next to the VTU/restart outputs — the regression record
    # production campaigns are judged by (docs/GOLDEN_RUN.md)
    from topopt_in_petsc_tpu.parallel.multihost import is_primary

    if is_primary() and history and history.get("fx"):
        import os

        import numpy as np

        np.savez(
            os.path.join(cfg.workdir, "history.npz"),
            **{k: np.asarray(v) for k, v in history.items()},
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
