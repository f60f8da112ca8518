"""API-surface tests: CLI parsing, config validation, MMA options
(RobustAsymptotesType, constraint modification, SetAsymptotes, KKT)."""

import jax.numpy as jnp
import numpy as np
import pytest

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.opt.mma import MMA


class TestCLI:
    def test_reference_flags(self):
        cfg = TopOptConfig.from_args(
            [
                "-nx", "129", "-ny", "65", "-nz", "65", "-penal", "3.5",
                "-volfrac", "0.2", "-rmin", "0.04", "-maxItr", "10",
                "-filter", "2", "-projectionFilter", "1", "-beta", "2",
                "-betaFinal", "16", "-eta", "0.5", "-Emin", "1e-6",
                "-movlim", "0.1", "-nu", "0.25", "-nlvls", "3",
                "-restart", "0", "-workdir", "/tmp/x",
            ]
        )
        assert (cfg.nx, cfg.ny, cfg.nz) == (129, 65, 65)
        assert cfg.penal == 3.5 and cfg.volfrac == 0.2
        assert cfg.filter == 2 and cfg.projectionFilter
        assert cfg.beta == 2.0 and cfg.betaFinal == 16.0
        assert cfg.Emin == 1e-6 and cfg.nu == 0.25
        assert not cfg.restart and cfg.workdir == "/tmp/x"

    def test_mesh_shape_flag(self):
        cfg = TopOptConfig.from_args(
            ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2",
             "-mesh_shape", "2,2,2"]
        )
        assert cfg.mesh_shape == (2, 2, 2)

    def test_unknown_flag_rejected(self):
        with pytest.raises(ValueError, match="unknown option"):
            TopOptConfig.from_args(["-bogus", "1"])

    def test_mg_divisibility_check(self):
        # 66 nodes -> 65 elements, not divisible by 8 (TopOpt.cc:183-201)
        with pytest.raises(ValueError, match="MULTIGRID"):
            TopOptConfig.from_args(["-nx", "66"])

    def test_sens_filter_floors_xmin(self):
        cfg = TopOptConfig.from_args(["-filter", "0"])
        assert cfg.Xmin == 0.001  # TopOpt.cc:357-359


class TestGrid:
    def test_coarsen_error(self):
        g = Grid(nn=(4, 4, 4))  # 3 elements per axis, odd
        with pytest.raises(ValueError):
            g.coarsen()

    def test_hierarchy_shapes(self):
        g = Grid(nn=(17, 9, 9))
        h = g.hierarchy(3)
        assert [x.nn for x in h] == [(17, 9, 9), (9, 5, 5), (5, 3, 3)]


class TestMMAOptions:
    def _run(self, mma, iters=15):
        shape = (3, 3, 3)
        n = 27
        rng = np.random.default_rng(0)
        c = -rng.uniform(1.0, 2.0, size=shape)
        x = jnp.full(shape, 0.4)
        for _ in range(iters):
            gx = jnp.asarray([float(jnp.mean(x)) - 0.4])
            dgdx = jnp.full((1, *shape), 1.0 / n)
            xmin, xmax = mma.set_outer_movelimit(0.0, 1.0, 0.2, x)
            x = mma.update(x, jnp.asarray(c), gx, dgdx, xmin, xmax)
        return x

    def test_robust_asymptotes_type1(self):
        mma = MMA(27, 1, (3, 3, 3), jnp.float64,
                  robust_asymptotes_type=1)
        x = self._run(mma)
        assert np.all(np.isfinite(np.asarray(x)))
        assert float(jnp.mean(x)) <= 0.4 + 1e-3

    def test_set_robust_type_validation(self):
        mma = MMA(8, 1, (2, 2, 2), jnp.float64)
        mma.set_robust_asymptotes_type(1)
        assert mma.robust_type == 1
        mma.set_robust_asymptotes_type(7)  # invalid -> stays (prints)
        assert mma.robust_type == 1

    def test_constraint_modification(self):
        mma = MMA(27, 1, (3, 3, 3), jnp.float64,
                  constraint_modification=True)
        x = self._run(mma)
        assert np.all(np.isfinite(np.asarray(x)))

    def test_set_asymptotes(self):
        mma = MMA(27, 1, (3, 3, 3), jnp.float64)
        mma.set_asymptotes(0.2, 0.65, 1.05)
        assert (mma.asyminit, mma.asymdec, mma.asyminc) == (
            0.2, 0.65, 1.05
        )
        x = self._run(mma)
        assert np.all(np.isfinite(np.asarray(x)))

    def test_kkt_residual(self):
        shape = (3, 3, 3)
        n = 27
        mma = MMA(n, 1, shape, jnp.float64)
        rng = np.random.default_rng(3)
        t = rng.uniform(0.3, 0.7, size=shape)
        x = jnp.full(shape, 0.5)
        dgdx = jnp.full((1, *shape), 1.0 / n)
        for it in range(40):
            dfdx = 2.0 * (x - t)
            gx = jnp.asarray([float(jnp.mean(x)) - 10.0])
            xmin, xmax = mma.set_outer_movelimit(0.0, 1.0, 0.5, x)
            x = mma.update(x, dfdx, gx, dgdx, xmin, xmax)
        dfdx = 2.0 * (x - t)
        gx = jnp.asarray([float(jnp.mean(x)) - 10.0])
        xmin, xmax = mma.set_outer_movelimit(0.0, 1.0, 0.5, x)
        n2, ninf = mma.kkt_residual(x, dfdx, gx, dgdx, xmin, xmax)
        # near the unconstrained optimum, KKT residuals are small
        assert n2 < 0.2 and ninf < 0.1


def test_fused_flag_routes_to_spmd_driver(tmp_path):
    """-fused 1 runs the single-program driver on a (1,1,1) mesh and
    matches the split driver's trajectory."""
    import numpy as np

    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.driver import run_topopt

    common = dict(
        nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, maxItr=3,
        dtype="float64", output_cadence_vtu=False, restart=False,
    )
    cfg1 = TopOptConfig(workdir=str(tmp_path / "a"), **common)
    cfg1.validate()
    h1 = run_topopt(cfg1)
    cfg2 = TopOptConfig(workdir=str(tmp_path / "b"), fused=True, **common)
    cfg2.validate()
    h2 = run_topopt(cfg2)
    np.testing.assert_allclose(h2["fx"], h1["fx"], rtol=1e-5)


@pytest.mark.slow
def test_beta_continuation_parity_across_drivers(tmp_path):
    """Projection + beta continuation: the fused and SPMD drivers must
    reproduce the interactive Driver's trajectory THROUGH a beta change
    (main.cc:92-98 ordering: IncreaseBeta, then FilterProject with the
    new beta before the next solve — previously the one-program drivers
    lagged the re-projection by one iteration)."""
    import numpy as np

    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.driver import run_topopt

    # beta triggers at itr % 10 == 0 with feasible gx -> 12 iterations
    # cross one continuation step.  betaFinal=4: normal increase
    # (changed=True); betaFinal=1.5: the clamp case, which moves beta
    # while reporting changed=False (Filter.cc:281-284) and must STILL
    # re-project before the next solve.
    for tag, bf in (("n", 4.0), ("c", 1.5)):
        common = dict(
            nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, maxItr=12,
            projectionFilter=True, beta=1.0, betaFinal=bf,
            dtype="float64", output_cadence_vtu=False, restart=False,
        )
        cfg1 = TopOptConfig(workdir=str(tmp_path / f"a{tag}"), **common)
        cfg1.validate()
        h1 = run_topopt(cfg1)
        cfg2 = TopOptConfig(
            workdir=str(tmp_path / f"b{tag}"), fused=True, **common
        )
        cfg2.validate()
        h2 = run_topopt(cfg2)
        np.testing.assert_allclose(h2["fx"], h1["fx"], rtol=1e-5)
        np.testing.assert_allclose(h2["mnd"], h1["mnd"], rtol=1e-4)
        cfg3 = TopOptConfig(
            workdir=str(tmp_path / f"c{tag}"), mesh_shape=(2, 2, 2),
            **common,
        )
        cfg3.validate()
        h3 = run_topopt(cfg3)
        np.testing.assert_allclose(h3["fx"], h1["fx"], rtol=1e-5)


def test_cross_driver_restart(tmp_path):
    """Checkpoints are layout-independent: written by the split driver,
    resumed by the fused (SPMD) driver."""
    import numpy as np

    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.driver import run_topopt

    common = dict(
        nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, dtype="float64",
        output_cadence_vtu=False,
    )
    cfg = TopOptConfig(workdir=str(tmp_path), maxItr=10, **common)
    cfg.validate()
    run_topopt(cfg)  # split driver, writes Restart00/01

    from topopt_in_petsc_tpu.io.restart import RestartManager

    latest = RestartManager(str(tmp_path)).latest()
    assert latest is not None
    cfg2 = TopOptConfig(
        workdir=str(tmp_path), maxItr=12, fused=True,
        restartFileVec=latest, **common,
    )
    cfg2.validate()
    h = run_topopt(cfg2)  # fused driver resumes at itr 10
    assert len(h["fx"]) <= 2
    assert all(np.isfinite(v) for v in h["fx"])


def test_profile_dir_writes_trace(tmp_path):
    import os

    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.driver import run_topopt

    cfg = TopOptConfig(
        nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, maxItr=1,
        output_cadence_vtu=False, restart=False,
        workdir=str(tmp_path / "w"), profile_dir=str(tmp_path / "prof"),
    )
    cfg.validate()
    run_topopt(cfg)
    found = []
    for root, _, files in os.walk(tmp_path / "prof"):
        found += files
    assert found, "no profiler trace files written"


class TestSolverOptions:
    """The solver options that remain, and the removed ones rejected."""

    def test_mg_dtype_values(self):
        assert TopOptConfig.from_args(["-mg_dtype", "bfloat16"]).mg_dtype \
            == "bfloat16"
        with pytest.raises(ValueError, match="mg_dtype"):
            TopOptConfig.from_args(["-mg_dtype", "mixed"])

    def test_operator_impl_values(self):
        for v in ("auto", "xla"):
            assert TopOptConfig.from_args(
                ["-operator_impl", v]
            ).operator_impl == v
        for v in ("pallas", "blocked", "triton"):
            with pytest.raises(ValueError, match="operator_impl"):
                TopOptConfig.from_args(["-operator_impl", v])

    def test_cli_flags_roundtrip(self):
        cfg = TopOptConfig.from_args(
            ["-cheby_lower", "0.3", "-smooth_sweeps", "2",
             "-ksp_type", "fgmres", "-coarse_maxit", "12"]
        )
        assert cfg.cheby_lower == 0.3 and cfg.smooth_sweeps == 2
        assert cfg.ksp_type == "fgmres" and cfg.coarse_maxit == 12
        assert TopOptConfig().cheby_lower == 0.06  # no size-based rule

    @pytest.mark.parametrize(
        "flag",
        ["-ksp_chunk", "-park_design", "-tail_split", "-mg_fine_post",
         "-ksp_monitor"],
    )
    def test_removed_options_rejected(self, flag):
        with pytest.raises(ValueError, match="unknown option"):
            TopOptConfig.from_args([flag, "1"])
