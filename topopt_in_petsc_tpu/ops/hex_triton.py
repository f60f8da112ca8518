"""Fused node-centric hex-operator matvec as a Pallas kernel (Triton route).

Same operator as `ops.hex_operator.apply_hex_operator` (free boundary
conditions, per-element scale), computed without the gather form's
``(nelem, 8*dof)`` intermediates.  Each program owns one x-plane of a
``(BY, BZ)`` tile of output nodes and forms, for every node n,

    out_i[n] = sum_a E(n - o_a) * sum_b sum_j KE[a,b]_ij * u_j[n + o_b - o_a]

(o_a the hex-corner offsets): 27 shifted loads of u per dof, 8 loads of
the element scale, and 8*8*dof*dof FMAs on the CUDA cores with the KE
blocks baked in as compile-time constants.  Nothing is accumulated across
programs, so the result is deterministic.

Loads take clamped flat indices; a neighbour index can only leave the
grid when its element does not exist, and that element's scale is loaded
as 0, so the clamped value never contributes.  Stores are masked to the
node extents, so any grid shape works (no power-of-two constraint).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from topopt_in_petsc_tpu.grid import CORNER_OFFSETS

DEFAULT_BLOCK = (4, 32)  # (BY, BZ) output nodes per program
DEFAULT_WARPS = 4


def _kernel(u_ref, e_ref, o_ref, *, nn, dof, ke, block):
    nx, ny, nz = nn
    ex, ey, ez = nx - 1, ny - 1, nz - 1
    by, bz = block
    x = pl.program_id(0)
    y0 = pl.program_id(1) * by
    z0 = pl.program_id(2) * bz
    y = y0 + lax.broadcasted_iota(jnp.int32, block, 0)
    z = z0 + lax.broadcasted_iota(jnp.int32, block, 1)

    # element scale at the 8 elements around each node (0 off the grid)
    E = []
    for ax, ay, az in CORNER_OFFSETS:
        i, j, k = x - ax, y - ay, z - az
        ok = (i >= 0) & (i < ex) & (j >= 0) & (j < ey) & (k >= 0) & (k < ez)
        off = jnp.clip((i * ey + j) * ez + k, 0, ex * ey * ez - 1)
        E.append(plgpu.load(e_ref.at[off], mask=ok, other=0.0)
                 .astype(jnp.float32))

    # t[a][i] = sum_b KE[a,b]_i. u[n + o_b - o_a], grouped by the shift d
    node = (x * ny + y) * nz + z
    last = nx * ny * nz - 1
    t = [[None] * dof for _ in range(8)]
    shifts = {}
    for a, oa in enumerate(CORNER_OFFSETS):
        for b, ob in enumerate(CORNER_OFFSETS):
            d = (ob[0] - oa[0], ob[1] - oa[1], ob[2] - oa[2])
            shifts.setdefault(d, []).append((a, b))
    for (dx, dy, dz), pairs in shifts.items():
        off = jnp.clip(node + (dx * ny + dy) * nz + dz, 0, last) * dof
        us = [plgpu.load(u_ref.at[off + jj]).astype(jnp.float32)
              for jj in range(dof)]
        for a, b in pairs:
            for ii in range(dof):
                for jj in range(dof):
                    c = float(ke[a * dof + ii, b * dof + jj])
                    if c == 0.0:
                        continue
                    term = c * us[jj]
                    t[a][ii] = term if t[a][ii] is None else t[a][ii] + term

    ok = (y < ny) & (z < nz)
    for ii in range(dof):
        acc = None
        for a in range(8):
            if t[a][ii] is None:
                continue
            term = E[a] * t[a][ii]
            acc = term if acc is None else acc + term
        plgpu.store(
            o_ref.at[x, pl.ds(y0, by), pl.ds(z0, bz), jnp.int32(ii)],
            acc.astype(o_ref.dtype),
            mask=ok,
        )


def make_triton_hex_apply(
    KE,
    *,
    block=DEFAULT_BLOCK,
    num_warps=DEFAULT_WARPS,
    interpret=False,
):
    """Returns ``apply(u, scale) -> K u`` for a constant element matrix.

    ``u`` is an ``(nx, ny, nz, dof)`` float32 nodal field, ``scale`` the
    ``(nx-1, ny-1, nz-1)`` element coefficients; the result equals
    ``apply_hex_operator(u, scale, KE)`` to float32 rounding.  ``KE`` must
    be concrete (its entries become kernel constants).  ``interpret=True``
    runs the kernel in the Pallas interpreter (CPU tests only).
    """
    ke = np.asarray(KE, dtype=np.float64)
    dof = ke.shape[0] // 8

    def apply(u, scale):
        nn = tuple(int(s) for s in u.shape[:3])
        if u.shape[3] != dof or scale.shape != tuple(n - 1 for n in nn):
            raise ValueError(
                f"shape mismatch: u {u.shape}, scale {scale.shape}, "
                f"dof {dof}"
            )
        if u.size >= 2**31:
            raise ValueError(f"nodal field too large for int32 indexing: "
                             f"{u.shape}")
        by, bz = block
        grid = (nn[0], pl.cdiv(nn[1], by), pl.cdiv(nn[2], bz))
        return pl.pallas_call(
            partial(_kernel, nn=nn, dof=dof, ke=ke, block=block),
            out_shape=jax.ShapeDtypeStruct(u.shape, u.dtype),
            grid=grid,
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=num_warps),
            interpret=interpret,
            name="hex_matvec",
        )(u.reshape(-1), scale.reshape(-1))

    return apply
