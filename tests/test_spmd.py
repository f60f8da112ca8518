"""SPMD halo-engine tests: overlapping-block decomposition, halo
primitives, and the shard_mapped solve vs the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from functools import partial
from jax import shard_map
from jax.sharding import PartitionSpec as P

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elasticity import LinearElasticity
from topopt_in_petsc_tpu.parallel.decomp import BlockDecomp
from topopt_in_petsc_tpu.parallel.mesh import make_device_mesh
from topopt_in_petsc_tpu.parallel.spmd import (
    AXIS_NAMES,
    ghost_fill_elem,
    halo_accumulate,
    peel,
    restrict_spmd,
    unpeel,
)
from topopt_in_petsc_tpu.parallel.spmd_model import (
    SpmdElasticity,
    make_spmd_fused_step,
)
from topopt_in_petsc_tpu.solvers.multigrid import restrict

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

MESH_SHAPE = (2, 2, 2)


def test_blocked_roundtrip():
    grid = Grid(nn=(17, 9, 9))
    d = BlockDecomp(grid, MESH_SHAPE, nlvls=2)
    rng = np.random.default_rng(0)
    nodal = rng.normal(size=(17, 9, 9, 3))
    blk = d.to_blocked_nodal(nodal)
    assert blk.shape == (2, 2, 2, 9, 5, 5, 3)
    np.testing.assert_allclose(d.from_blocked_nodal(blk), nodal)
    elem = rng.normal(size=(16, 8, 8))
    blk = d.to_blocked_elem(elem[..., None])[..., 0]
    np.testing.assert_allclose(
        d.from_blocked_elem(blk[..., None])[..., 0], elem
    )


def test_halo_accumulate_completes_scatter():
    """Blocked partial scatter + halo_accumulate == global scatter."""
    from topopt_in_petsc_tpu.ops.hex_operator import (
        scatter_element_dofs,
    )

    grid = Grid(nn=(9, 9, 9))
    d = BlockDecomp(grid, MESH_SHAPE, nlvls=1)
    mesh = make_device_mesh(MESH_SHAPE)
    rng = np.random.default_rng(1)
    fe = rng.normal(size=(8, 8, 8, 24))
    ref = scatter_element_dofs(jnp.asarray(fe), (9, 9, 9))

    fe_blk = jnp.asarray(d.to_blocked_elem(fe))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(*AXIS_NAMES),
        out_specs=P(*AXIS_NAMES),
        check_vma=False,
    )
    def run(fe_loc):
        f = peel(fe_loc)
        out = scatter_element_dofs(f, (5, 5, 5))
        return unpeel(halo_accumulate(out, MESH_SHAPE))

    blk = run(fe_blk)
    got = d.from_blocked_nodal(np.asarray(blk))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-12)
    # consistency of duplicated planes: overlapping entries must agree
    b = np.asarray(blk)
    np.testing.assert_allclose(b[0, 0, 0, -1], b[1, 0, 0, 0], rtol=1e-12)


def test_ghost_fill_matches_global_pad():
    grid = Grid(nn=(9, 9, 9))
    d = BlockDecomp(grid, MESH_SHAPE, nlvls=1)
    mesh = make_device_mesh(MESH_SHAPE)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 8, 8))
    w = 2
    xpad = np.pad(x, w)

    x_blk = jnp.asarray(d.to_blocked_elem(x[..., None]))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(*AXIS_NAMES),
        out_specs=P(*AXIS_NAMES),
        check_vma=False,
    )
    def run(x_loc):
        f = peel(x_loc)[..., 0]
        return unpeel(ghost_fill_elem(f, w, MESH_SHAPE)[..., None])

    blk = np.asarray(run(x_blk))
    # each local block must equal the corresponding padded-global window
    for i in range(2):
        for j in range(2):
            for k in range(2):
                win = xpad[
                    i * 4 : i * 4 + 4 + 2 * w,
                    j * 4 : j * 4 + 4 + 2 * w,
                    k * 4 : k * 4 + 4 + 2 * w,
                ]
                np.testing.assert_allclose(
                    blk[i, j, k, ..., 0], win, rtol=1e-12
                )


def test_restrict_spmd_matches_global():
    grid = Grid(nn=(9, 9, 9))
    d = BlockDecomp(grid, MESH_SHAPE, nlvls=2)
    mesh = make_device_mesh(MESH_SHAPE)
    rng = np.random.default_rng(3)
    f = rng.normal(size=(9, 9, 9, 1))
    ref = restrict(jnp.asarray(f))

    f_blk = jnp.asarray(d.to_blocked_nodal(f))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(*AXIS_NAMES),
        out_specs=P(*AXIS_NAMES),
        check_vma=False,
    )
    def run(f_loc):
        return unpeel(restrict_spmd(peel(f_loc), MESH_SHAPE))

    blk = run(f_blk)
    got = d.from_blocked_nodal(np.asarray(blk), level=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize(
    "mesh_shape", [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2)]
)
def test_spmd_solve_matches_single_device(mesh_shape):
    """Full SPMD MG-PCG physics step == single-device physics step."""
    cfg = TopOptConfig(
        nx=17, ny=9, nz=9, nlvls=2, dtype="float64", rmin=0.16,
        mesh_shape=mesh_shape,
    )
    cfg.validate()
    rng = np.random.default_rng(4)
    x = rng.uniform(0.3, 0.9, size=(16, 8, 8))

    # single-device reference
    phys = LinearElasticity(cfg)
    ref = phys.compute_objective_constraints_sensitivities(
        jnp.asarray(x), jnp.zeros((17, 9, 9, 3))
    )

    mesh = make_device_mesh(mesh_shape,
                            jax.devices()[:int(np.prod(mesh_shape))])
    engine = SpmdElasticity(cfg, mesh)
    x_blk = engine.blocked_elem(x)
    u0_blk = engine.zeros_nodal_blk()
    (u_blk, iters, relres, fx, gx, dfdx_blk, dgdx_blk) = (
        engine.compute_objective_constraints_sensitivities(x_blk, u0_blk)
    )

    np.testing.assert_allclose(float(fx), float(ref.fx), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(gx), np.asarray(ref.gx), atol=1e-12
    )
    dfdx = engine.decomp.from_blocked_elem(
        np.asarray(dfdx_blk)[..., None]
    )[..., 0]
    np.testing.assert_allclose(
        dfdx, np.asarray(ref.dfdx), rtol=1e-6, atol=1e-12
    )
    u = engine.decomp.from_blocked_nodal(np.asarray(u_blk))
    np.testing.assert_allclose(
        u, np.asarray(ref.u), rtol=1e-5, atol=1e-10
    )
    # identical start field + identical math => identical iteration counts
    assert abs(int(iters) - int(ref.iters)) <= 1


def test_spmd_fused_step_runs():
    cfg = TopOptConfig(
        nx=17, ny=9, nz=9, nlvls=2, dtype="float64", rmin=0.16,
        mesh_shape=MESH_SHAPE,
    )
    cfg.validate()
    step, state, engine = make_spmd_fused_step(cfg)
    s1 = step(state)
    s2 = step(s1)
    assert np.isfinite(float(s2.fx)) and float(s2.fx) > 0
    assert float(s2.ch) <= cfg.movlim + 1e-9
    # volume constraint moves toward feasibility
    assert float(s2.gx[0]) < float(s1.gx[0]) + 1e-6


def test_spmd_kernel_fine_apply_matches():
    """The fused kernel (interpret mode) as the LOCAL fine-level operator
    inside the SPMD solve matches the XLA local operator."""
    from topopt_in_petsc_tpu.models.elements import hex8_stiffness
    from topopt_in_petsc_tpu.ops.hex_triton import make_triton_hex_apply

    mesh_shape = (2, 1, 1)
    cfg = TopOptConfig(
        nx=17, ny=9, nz=9, nlvls=2, dtype="float32", mesh_shape=mesh_shape,
    )
    cfg.validate()
    mesh = make_device_mesh(mesh_shape, jax.devices()[:2])
    eng = SpmdElasticity(cfg, mesh)
    x = eng.blocked_elem(
        np.random.default_rng(3).uniform(0.2, 0.9, eng.grid.ne)
    )
    ref = eng.compute_objective_constraints_sensitivities(
        x, eng.zeros_nodal_blk()
    )

    eng2 = SpmdElasticity(cfg, mesh)
    eng2.mg.fine_apply = make_triton_hex_apply(
        hex8_stiffness(*eng2.grid.h, cfg.nu), block=(4, 8),
        interpret=True,
    )
    eng2._solve_sm = eng2._build_solve()
    res = eng2.compute_objective_constraints_sensitivities(
        x, eng2.zeros_nodal_blk()
    )

    assert abs(int(res[1]) - int(ref[1])) <= 1  # iters
    np.testing.assert_allclose(
        float(res[3]), float(ref[3]), rtol=5e-4
    )  # fx


def test_spmd_mg_dtype_bf16_converges():
    """-mg_dtype bfloat16 on the SPMD engine: bf16 V-cycle storage with
    the f32 outer Krylov still converges to the f32 solution."""
    common = dict(
        nx=17, ny=9, nz=9, nlvls=2, dtype="float32", rmin=0.16,
        mesh_shape=MESH_SHAPE, ksp_rtol=1e-5,
    )
    rng = np.random.default_rng(21)
    x = rng.uniform(0.3, 0.9, size=(16, 8, 8))

    cfg1 = TopOptConfig(**common)
    cfg1.validate()
    e1 = SpmdElasticity(cfg1)
    ref = e1.compute_objective_constraints_sensitivities(
        e1.blocked_elem(x), e1.zeros_nodal_blk()
    )

    cfg2 = TopOptConfig(mg_dtype="bfloat16", **common)
    cfg2.validate()
    e2 = SpmdElasticity(cfg2)
    assert e2.mg.precond_dtype == jnp.bfloat16
    got = e2.compute_objective_constraints_sensitivities(
        e2.blocked_elem(x), e2.zeros_nodal_blk()
    )

    assert float(got[2]) < cfg2.ksp_rtol  # converged (relres)
    assert float(got[3]) == pytest.approx(float(ref[3]), rel=1e-3)  # fx
    u_ref = e1.decomp.from_blocked_nodal(np.asarray(ref[0]))
    u_got = e2.decomp.from_blocked_nodal(np.asarray(got[0]))
    scale = np.max(np.abs(u_ref))
    np.testing.assert_allclose(
        u_got, u_ref, rtol=1e-2, atol=1e-3 * scale
    )


def test_spmd_fft_filter_matches_single_device():
    """FFT filter backend on the SPMD engine (rmin big enough that
    (2s+1)^3 > FFT_TAP_THRESHOLD): the spectra travel as jit ARGUMENTS
    on both engines (not as embedded constants), and the fused
    trajectories must agree."""
    from topopt_in_petsc_tpu.opt.filters import filter_stencil_halfwidth
    from topopt_in_petsc_tpu.ops.conv_filter import FFT_TAP_THRESHOLD
    from topopt_in_petsc_tpu.parallel.fused_step import make_fused_step

    common = dict(
        nx=17, ny=9, nz=9, nlvls=2, dtype="float32", rmin=0.6,
        ksp_rtol=1e-6,
    )
    cfg = TopOptConfig(mesh_shape=MESH_SHAPE, **common)
    cfg.validate()
    grid_h = (2.0 / 16, 1.0 / 8, 1.0 / 8)
    s = filter_stencil_halfwidth(cfg.rmin, grid_h, (17, 9, 9))
    assert (2 * s + 1) ** 3 > FFT_TAP_THRESHOLD  # FFT path engaged

    step, state, engine = make_spmd_fused_step(cfg)
    for itr in (1, 2):
        state = step(state, itr)

    cfg1 = TopOptConfig(**common)
    cfg1.validate()
    step1, state1 = make_fused_step(cfg1)
    for itr in (1, 2):
        state1 = step1(state1, itr)

    assert float(state.fx) == pytest.approx(float(state1.fx), rel=1e-4)
    xs = engine.decomp.from_blocked_elem(np.asarray(state.xPhys))
    np.testing.assert_allclose(
        xs, np.asarray(state1.xPhys), atol=5e-5
    )
