"""Smoke test of the optimizer on one NVIDIA GPU (or four, with --four).

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # the 4-card mesh path vs one card

Phases (one process drives the card; only `nvidia-smi` runs as a child):
  1. device     — JAX must see a GPU; prints the card's name and power
                  limit and which VTU codec loaded.
  2. kernel     — the fine-level matvec at 256^3 elements: the fused
                  kernel and the XLA float32 form against the float64
                  reference on the card, with their timings; the kernel
                  must give the same bits on two calls.
  3. golden     — the CLI at 65x33x33 for 20 iterations against the
                  float64 trajectory docs/golden_history_65x33x33.npz.
  4. real size  — the CLI at 257^3 nodes, -nlvls 5.  float32 (the
                  production path, fused kernel): split and -fused 1 for
                  3 iterations each, output and restart writes on, every
                  solve converged.  float64 (the XLA form): split vs
                  -fused 1 over 3 iterations, and a split run stopped at
                  3 and resumed from its restart files vs a straight run
                  at iteration 4, fx within rtol 1e-4.

--four runs the 257^3 problem in float64 on a 4-card mesh and with
-fused 1 on card 0, and holds their fx to rtol 1e-4.  The agreement
checks run in float64 because float32 trajectories of programs that sum
in different orders drift apart by ~1e-4 within three iterations at this
size: that is rounding, not a fault, and it would hide one.

Any failed phase exits non-zero and prints no result.  The last line of
a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# matvec tolerances: float32 rounding over 64 products of 3x3 blocks
# (TF32 products would fail them)
MATVEC_REL_L2 = 2e-6
MATVEC_REL_MAX = 1e-5
# float32 fx vs the float64 golden: float32 itself strays up to 1.3e-3
# from float64 over these 20 iterations (1.31e-3 on the CPU, 1.29e-3 on
# the H100), so the limit is twice that
GOLDEN_RTOL = 2.5e-3
# float64 runs of different programs (split, fused, resumed, 4-card)
AGREE_RTOL = 1e-4
RELRES_MAX = 1e-5


class PhaseFailed(Exception):
    pass


def rel_errors(got, ref):
    """(relative L2 error, max error over max|ref|) of two arrays."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return (
        float(np.linalg.norm(got - ref) / np.linalg.norm(ref)),
        float(np.abs(got - ref).max() / np.abs(ref).max()),
    )


def check_matvec(name, rel_l2, rel_max):
    ok = rel_l2 <= MATVEC_REL_L2 and rel_max <= MATVEC_REL_MAX
    print(f"  {name}: rel L2 {rel_l2:.3e} (<= {MATVEC_REL_L2:g}), "
          f"max/max|Ku| {rel_max:.3e} (<= {MATVEC_REL_MAX:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailed(f"{name} disagrees with the float64 reference")


def check_agree(name, a, b, rtol):
    """fx trajectories agree at every common iteration within rtol."""
    from compare_history import max_rel_diff

    d = max_rel_diff(a, b)
    ok = len(a) > 0 and len(b) > 0 and d <= rtol
    print(f"  {name}: max rel fx diff {d:.3e} (<= {rtol:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailed(f"{name}: fx trajectories disagree")


def check_relres(name, relres, limit=RELRES_MAX):
    worst = max(relres) if len(relres) else float("inf")
    ok = worst <= limit
    print(f"  {name}: worst solve relres {worst:.3e} (<= {limit:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailed(f"{name}: a state solve did not converge")


def result_line(platform, kind, count):
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise PhaseFailed("nvidia-smi printed nothing")
    return out


def _median_time(fn, *args, reps=20):
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0)


# ------------------------------------------------------------------ #


def phase_device(expect_count):
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"# device: {d.platform} {d.device_kind} x{len(devs)}",
          flush=True)
    if d.platform != "gpu":
        raise PhaseFailed(f"no GPU: JAX found {d.platform}")
    if len(devs) < expect_count:
        raise PhaseFailed(f"needs {expect_count} GPUs, found {len(devs)}")
    print(f"# card: {card_info()}", flush=True)
    from topopt_in_petsc_tpu.io import native

    codec = "native" if native._build_and_load() is not None else \
        "pure-Python fallback"
    print(f"# VTU codec: {codec}", flush=True)
    return d


def phase_kernel(ne=256):
    import jax
    import jax.numpy as jnp

    from topopt_in_petsc_tpu.models.elements import hex8_stiffness
    from topopt_in_petsc_tpu.ops.hex_operator import apply_hex_operator
    from topopt_in_petsc_tpu.ops.hex_triton import make_triton_hex_apply

    n = ne + 1
    KE = hex8_stiffness(2.0 / ne, 1.0 / ne, 1.0 / ne, 0.3)
    ku, ke = jax.random.split(jax.random.PRNGKey(0))
    u64 = jax.random.normal(ku, (n, n, n, 3), jnp.float64)
    E64 = jax.random.uniform(ke, (ne, ne, ne), jnp.float64,
                             minval=1e-9, maxval=1.0)
    ref = jax.jit(lambda u, E: apply_hex_operator(u, E, jnp.asarray(KE)))(
        u64, E64
    )
    u, E = u64.astype(jnp.float32), E64.astype(jnp.float32)
    del u64, E64
    forms = {
        "xla f32 HIGHEST": jax.jit(lambda u, E: apply_hex_operator(
            u, E, jnp.asarray(KE, jnp.float32))),
        "fused kernel": jax.jit(make_triton_hex_apply(KE)),
    }
    print(f"# phase 2: fine matvec at {ne}^3 elements vs float64 "
          f"reference", flush=True)
    for name, fn in forms.items():
        got = fn(u, E)
        check_matvec(name, *rel_errors(got, ref))
        same = bool(jnp.array_equal(got, fn(u, E)))
        print(f"  {name}: two calls bitwise equal: {same}", flush=True)
        if name == "fused kernel" and not same:
            raise PhaseFailed("the fused kernel is not deterministic")
        del got
        t = _median_time(fn, u, E)
        print(f"  {name}: {t * 1e3:.3f} ms per matvec (median of 20)",
              flush=True)


def _cli(argv):
    from topopt_in_petsc_tpu.__main__ import main

    t0 = time.perf_counter()
    rc = main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise PhaseFailed(f"CLI exited {rc}: {' '.join(argv)}")
    import numpy as np

    wd = argv[argv.index("-workdir") + 1]
    h = dict(np.load(os.path.join(wd, "history.npz")))
    # the .vtu dumps at 257^3 are ~0.5 GB each: count, then drop them
    vtus = [f for f in os.listdir(wd) if f.endswith(".vtu")]
    for f in vtus:
        os.remove(os.path.join(wd, f))
    t = [float(v) for v in h["time"]]
    # the first iteration includes the compilation of the loop's programs
    print(f"  wall {wall:.1f} s; set-up outside the loop "
          f"{wall - sum(t):.1f} s; per-iteration s: "
          f"{', '.join(f'{v:.3f}' for v in t)}; solver iterations "
          f"{[int(v) for v in h['iters']]}; process peak device memory "
          f"so far {_peak_bytes() / 2**30:.2f} GiB; {len(vtus)} .vtu files",
          flush=True)
    return h


def phase_golden(work):
    import numpy as np

    print("# phase 3: 65x33x33, 20 iterations, float32 vs the float64 "
          "golden trajectory", flush=True)
    wd = os.path.join(work, "golden")
    h = _cli(["-maxItr", "20", "-workdir", wd])
    g = np.load(os.path.join(REPO, "docs", "golden_history_65x33x33.npz"))
    print(f"  iteration 1: fx {h['fx'][0]:.6f}, float64 golden "
          f"{g['fx'][0]:.6f}", flush=True)
    check_agree("fx vs golden", g["fx"][:20], h["fx"], GOLDEN_RTOL)
    check_relres("65x33x33", h["relres"])


def _memory_analysis(common):
    """Compiled memory of the split driver's state-solve program."""
    import jax.numpy as jnp

    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.models.elasticity import LinearElasticity

    cfg = TopOptConfig.from_args(common + ["-workdir", "/dev/null"])
    phys = LinearElasticity(cfg)
    x = jnp.full(phys.grid.ne, cfg.volfrac, cfg.jnp_dtype)
    u0 = jnp.zeros((*phys.grid.nn, 3), cfg.jnp_dtype)
    m = phys._solve.lower(x, u0, phys.RHS, phys.mask_args()) \
        .compile().memory_analysis()
    print(f"  solve program memory_analysis: temp "
          f"{m.temp_size_in_bytes / 2**30:.2f} GiB, arguments "
          f"{m.argument_size_in_bytes / 2**30:.2f} GiB, output "
          f"{m.output_size_in_bytes / 2**30:.2f} GiB", flush=True)


def _resume(common, work, name):
    """A split run stopped at iteration 3, then resumed from its restart
    files (design, MMA history and the state field) for iteration 4."""
    from topopt_in_petsc_tpu.io.restart import RestartManager

    wd = os.path.join(work, name)
    print(f"  {name}: split driver, 3 iterations (restart at 3):",
          flush=True)
    _cli(common + ["-maxItr", "3", "-workdir", wd])
    latest = RestartManager(wd).latest()
    if latest is None:
        raise PhaseFailed("the split run wrote no restart file")
    sol = os.path.join(wd, os.path.basename(latest)
                       .replace("Restart", "RestartSol"))
    print(f"  {name}: resume iteration 4 from {os.path.basename(latest)}:",
          flush=True)
    return _cli(common + ["-maxItr", "4", "-workdir", wd,
                          "-restartFileVec", latest,
                          "-restartFileVecSol", sol])


def phase_real_size(work, n=257, nlvls=5):
    common = ["-nx", str(n), "-ny", str(n), "-nz", str(n),
              "-nlvls", str(nlvls)]
    print(f"# phase 4: {n}^3 nodes ({3 * n**3} dof), -nlvls {nlvls}",
          flush=True)
    _memory_analysis(common)
    # float32, the production path: output and restart writes on
    print("  float32 split driver, 3 iterations:", flush=True)
    hs = _cli(common + ["-maxItr", "3", "-workdir",
                        os.path.join(work, "split32")])
    print("  float32 -fused 1, 3 iterations:", flush=True)
    hf = _cli(common + ["-maxItr", "3", "-fused", "1", "-workdir",
                        os.path.join(work, "fused32")])
    check_relres("float32 split", hs["relres"])
    check_relres("float32 fused", hf["relres"])
    # float64: the agreement checks
    c64 = common + ["-dtype", "float64", "-output_cadence_vtu", "0"]
    print("  float64 split driver, 4 iterations straight through:",
          flush=True)
    hs64 = _cli(c64 + ["-maxItr", "4", "-restart", "0", "-workdir",
                       os.path.join(work, "split64")])
    hr64 = _resume(c64, work, "resume64")
    print("  float64 -fused 1, 3 iterations:", flush=True)
    hf64 = _cli(c64 + ["-maxItr", "3", "-fused", "1", "-restart", "0",
                       "-workdir", os.path.join(work, "fused64")])
    for name, h in (("float64 split", hs64), ("float64 resumed", hr64),
                    ("float64 fused", hf64)):
        check_relres(name, h["relres"])
    check_agree("float64 split vs fused, iterations 1-3", hs64["fx"][:3],
                hf64["fx"], AGREE_RTOL)
    if len(hr64["fx"]) != 1:
        raise PhaseFailed(f"resume ran {len(hr64['fx'])} iterations, not 1")
    check_agree("float64 resumed vs straight-through iteration 4",
                hs64["fx"][3:4], hr64["fx"], AGREE_RTOL)
    from compare_history import max_rel_diff

    print(f"  float32 vs float64 fx (rounding of float32, not gated): "
          f"split {max_rel_diff(hs64['fx'][:3], hs['fx']):.3e}, fused "
          f"{max_rel_diff(hf64['fx'], hf['fx']):.3e}", flush=True)


def phase_four(work, n=257, nlvls=5, mesh="4,1,1"):
    """The problem on a 4-card mesh (SpmdDriver) vs -fused 1 on card 0,
    in float64."""
    common = ["-nx", str(n), "-ny", str(n), "-nz", str(n),
              "-nlvls", str(nlvls), "-maxItr", "3", "-dtype", "float64",
              "-restart", "0", "-output_cadence_vtu", "0"]
    print(f"# four cards: {n}^3, -nlvls {nlvls}, float64, -mesh_shape "
          f"{mesh} vs one card", flush=True)
    print(f"  -mesh_shape {mesh}:", flush=True)
    h4 = _cli(common + ["-mesh_shape", mesh, "-workdir",
                        os.path.join(work, "mesh4")])
    print("  -mesh_shape 1,1,1 -fused 1 (card 0):", flush=True)
    h1 = _cli(common + ["-fused", "1", "-workdir",
                        os.path.join(work, "mesh1")])
    check_relres("4 cards", h4["relres"])
    check_relres("1 card", h1["relres"])
    check_agree("4 cards vs 1 card", h1["fx"], h4["fx"], AGREE_RTOL)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    if set(argv) - {"--four"}:
        print("usage: python chip_smoke.py [--four]", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import topopt_in_petsc_tpu  # noqa: F401
        import compare_history  # noqa: F401
    except ImportError as e:
        print(f"FAILED: the repository is not next to this script ({e})",
              file=sys.stderr)
        return 1

    import jax

    jax.config.update("jax_enable_x64", True)
    from topopt_in_petsc_tpu.utils.compile_cache import enable_compile_cache

    print(f"# compile cache: {enable_compile_cache()}", flush=True)
    try:
        dev = phase_device(4 if four else 1)
        with tempfile.TemporaryDirectory(dir=REPO,
                                         prefix=".smoke_") as work:
            if four:
                phase_four(work)
            else:
                phase_kernel()
                phase_golden(work)
                phase_real_size(work)
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(dev.platform, dev.device_kind,
                      4 if four else len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
