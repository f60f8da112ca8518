"""Device mesh + sharding specs: the DMDA domain decomposition in JAX.

The reference decomposes its structured grids into per-rank sub-boxes with
PETSc's DMDA (`DMDACreate3d(..., PETSC_DECIDE x3, ...)`, TopOpt.cc:233) and
forces every other mesh onto the same ownership ranges (TopOpt.cc:253-291,
Filter.cc:339-365, PDEFilter.cc:100-126) so design, state and filter fields
are co-partitioned.  Ghost values move via DMGlobalToLocal before every
element loop, and every SpMV/dot crosses rank boundaries through
PETSc-internal VecScatters (SURVEY §2.2).

Here the same decomposition is one `jax.sharding.Mesh` with axes
('x', 'y', 'z'): nodal fields shard as P('x','y','z', None) and element
fields as P('x','y','z') — co-partitioning is automatic because both
shardings split the same grid axes.  Halo exchange needs no code at all:
the hex operator's shifted slices and the filter's convolutions are
partitioned by XLA GSPMD, which inserts the neighbor collective-permutes
(the DMGlobalToLocal equivalent) and keeps interior compute local.  Scalar
reductions (objective, dots, MMA's m-sized quantities) become psums over
the mesh (the reference's ~11 MPI_Allreduce sites, SURVEY §2.2.3).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("x", "y", "z")


def make_device_mesh(
    mesh_shape: Tuple[int, int, int] = (1, 1, 1),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build the ('x','y','z') device mesh.

    mesh_shape must multiply to the device count used.  (1,1,1) with one
    device gives the single-device degenerate mesh — all code paths are
    identical, collectives become no-ops.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = int(np.prod(mesh_shape))
    if n > len(devices):
        raise ValueError(
            f"mesh_shape {mesh_shape} needs {n} devices, "
            f"have {len(devices)}"
        )
    dev_array = np.array(devices[:n]).reshape(mesh_shape)
    return Mesh(dev_array, AXES)


def elem_sharding(mesh: Mesh, extra_dims: int = 0) -> NamedSharding:
    """Sharding for (ex, ey, ez[, ...]) element fields (replicated tail
    dims, e.g. the m-axis of dgdx)."""
    spec = P(*AXES, *([None] * extra_dims))
    return NamedSharding(mesh, spec)


def node_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (nx, ny, nz, dof) nodal fields at jit boundaries.

    Nodal grids have odd extents (n = e + 1) which XLA's GSPMD API refuses
    to split unevenly at jit boundaries, so nodal *inputs/outputs* are
    replicated; inside jit the element-sharded operands drive XLA to
    partition the interior compute (intermediates may be unevenly sharded
    internally).  The scalable path for giga-voxel runs is the explicit
    shard_map halo engine (parallel.spmd), which carries overlapping local
    blocks instead.
    """
    return NamedSharding(mesh, P())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_fields(mesh: Mesh, *, nodal=(), elem=(), elem_m=()):
    """Device-put field groups with their canonical shardings."""
    ns, es, ems = node_sharding(mesh), elem_sharding(mesh), elem_sharding(
        mesh, extra_dims=0
    )
    out_nodal = tuple(jax.device_put(a, ns) for a in nodal)
    out_elem = tuple(jax.device_put(a, es) for a in elem)
    m_shard = NamedSharding(mesh, P(None, *AXES))
    out_elem_m = tuple(jax.device_put(a, m_shard) for a in elem_m)
    return out_nodal, out_elem, out_elem_m
