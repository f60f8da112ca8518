"""SPMD halo engine: shard_map + ppermute over overlapping blocks.

This is the scalable multi-device execution path (SURVEY §7.2 step 7 and the
BASELINE north star): the structured grid is block-partitioned over the
('x','y','z') device mesh exactly like PETSc's DMDA partitions it over MPI
ranks, and the ghost traffic the reference gets from DMGlobalToLocal /
VecScatter (LinearElasticity.cc:249, SURVEY §2.2.2) is explicit
`lax.ppermute` plane exchange between neighbouring devices:

 - `halo_accumulate`: completes FEM scatter-adds on duplicated planes
   (one ±plane exchange per axis, axis-sequenced so edge/corner nodes
   accumulate correctly),
 - `ghost_fill_elem`: widens element blocks by `w` ghost layers for the
   density-filter convolution (the reference's variable-width filter
   ghosts, Filter.cc:326-368),
 - ownership-weighted `dot` + psum: the reference's MPI_Allreduce dots.

All solver components (hex operator, Chebyshev, multigrid transfers, CG,
MMA reductions) run *inside one shard_map region*, so the whole state
solve — or the whole optimization step — is a single SPMD program with
purely local tensor ops + explicit neighbor collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from topopt_in_petsc_tpu.models.elements import galerkin_octant_matrices
from topopt_in_petsc_tpu.ops.hex_operator import (
    apply_hex_operator,
    apply_hex_operator_octant,
    hex_operator_diagonal,
    hex_operator_diagonal_octant,
    octant_split,
)
from topopt_in_petsc_tpu.solvers.cg import pcg
from topopt_in_petsc_tpu.solvers.chebyshev import (
    chebyshev_smooth,
    gershgorin_lambda_max,
)
from topopt_in_petsc_tpu.solvers.multigrid import (
    coarsen_cell_field,
    prolong,
)

AXIS_NAMES = ("x", "y", "z")


# ------------------------------------------------------------------ #
# ppermute plumbing


def _perm_to_lower(m: int):
    """Device i sends to i-1 (data flows toward lower coordinates)."""
    return [(i, i - 1) for i in range(1, m)]


def _perm_to_higher(m: int):
    return [(i, i + 1) for i in range(m - 1)]


def _plane_idx(ndim: int, axis: int, idx):
    out = [slice(None)] * ndim
    out[axis] = idx
    return tuple(out)


def halo_accumulate_axis(u: jax.Array, axis: int, m: int) -> jax.Array:
    """Complete partial sums on the two duplicated planes along one axis.

    Both copies of a shared plane end up holding the identical total
    (exchange uses pre-update values, so the operation is symmetric).
    """
    if m == 1:
        return u
    name = AXIS_NAMES[axis]
    spatial_axis = axis  # local layout (nxl, nyl, nzl, dof)
    lo = u[_plane_idx(u.ndim, spatial_axis, 0)]
    hi = u[_plane_idx(u.ndim, spatial_axis, u.shape[spatial_axis] - 1)]
    from_higher = lax.ppermute(lo, name, _perm_to_lower(m))
    from_lower = lax.ppermute(hi, name, _perm_to_higher(m))
    u = u.at[_plane_idx(u.ndim, spatial_axis, u.shape[spatial_axis] - 1)].add(
        from_higher
    )
    u = u.at[_plane_idx(u.ndim, spatial_axis, 0)].add(from_lower)
    return u


def halo_accumulate(u: jax.Array, mesh_shape) -> jax.Array:
    for a in range(3):
        u = halo_accumulate_axis(u, a, mesh_shape[a])
    return u


def ghost_fill_elem(x: jax.Array, width: int, mesh_shape) -> jax.Array:
    """Widen an element block by `width` ghost layers per side per axis.

    Neighbor slabs arrive via ppermute; global edges get zeros (matching
    the zero-padded global convolution).  Axis-sequenced so the corner
    ghost regions fill transitively.
    """
    for a in range(3):
        m = mesh_shape[a]
        n = x.shape[a]
        if m == 1:
            pad = [(0, 0)] * x.ndim
            pad[a] = (width, width)
            x = jnp.pad(x, pad)
            continue
        name = AXIS_NAMES[a]
        idx_lo = [slice(None)] * x.ndim
        idx_lo[a] = slice(0, width)
        idx_hi = [slice(None)] * x.ndim
        idx_hi[a] = slice(n - width, n)
        from_lower = lax.ppermute(x[tuple(idx_hi)], name, _perm_to_higher(m))
        from_higher = lax.ppermute(x[tuple(idx_lo)], name, _perm_to_lower(m))
        x = jnp.concatenate([from_lower, x, from_higher], axis=a)
    return x


def make_psum_dot(w: jax.Array, precise: bool = True) -> Callable:
    """Globally-correct inner product on consistent overlapping vectors:
    ownership-weighted local sum + psum over the mesh."""

    def dot(a, b):
        prod = a * b * w
        if precise and prod.dtype != jnp.float64:
            # widen inside the reduce, not as a full-size f64 copy
            # (see solvers/cg._dot)
            return lax.psum(
                jnp.sum(prod, dtype=jnp.float64), AXIS_NAMES
            )
        return lax.psum(jnp.sum(prod), AXIS_NAMES)

    return dot


def psum_scalar(s):
    return lax.psum(s, AXIS_NAMES)


def pmax_scalar(s):
    return lax.pmax(s, AXIS_NAMES)


# ------------------------------------------------------------------ #
# SPMD transfer operators


def restrict_axis_spmd(
    f: jax.Array, axis: int, m: int
) -> jax.Array:
    """Weighted one-axis restriction c[i] = f[2i] + 0.5(f[2i-1]+f[2i+1])
    on overlapping blocks: the duplicated center term is counted by its
    owner only, off-center terms are local, then a plane exchange
    completes (and re-consistifies) the shared coarse planes."""
    nf = f.shape[axis]
    nc = (nf - 1) // 2 + 1

    even = [slice(None)] * f.ndim
    even[axis] = slice(0, None, 2)
    odd = [slice(None)] * f.ndim
    odd[axis] = slice(1, None, 2)
    f_even = f[tuple(even)]
    f_odd = f[tuple(odd)]

    if m > 1:
        # center weight: plane 0 owned by the lower neighbor unless we
        # are the first device along this axis
        first = (lax.axis_index(AXIS_NAMES[axis]) == 0).astype(f.dtype)
        shape = [1] * f.ndim
        shape[axis] = nc
        idx = lax.broadcasted_iota(jnp.int32, tuple(shape), axis)
        w_center = jnp.where(idx == 0, first, 1.0).astype(f.dtype)
        c = f_even * w_center
    else:
        c = f_even

    head = [slice(None)] * f.ndim
    head[axis] = slice(1, None)
    tail = [slice(None)] * f.ndim
    tail[axis] = slice(None, -1)
    c = c.at[tuple(head)].add(0.5 * f_odd)
    c = c.at[tuple(tail)].add(0.5 * f_odd)
    return halo_accumulate_axis(c, axis, m)


def restrict_spmd(r: jax.Array, mesh_shape) -> jax.Array:
    for a in range(3):
        r = restrict_axis_spmd(r, a, mesh_shape[a])
    return r


# prolongation is purely local on overlapping blocks (shared planes and
# all interpolation sources are present locally):
prolong_spmd = prolong


# ------------------------------------------------------------------ #
# SPMD geometric multigrid (mirrors solvers.multigrid.GeometricMultigrid
# with halo-completing operator applications and psum dots)


class SpmdMultigrid:
    def __init__(
        self,
        decomp,
        KEs: List[np.ndarray],
        dof: int,
        *,
        dtype=jnp.float32,
        smooth_sweeps: int = 4,
        cheby_lower: float = 0.06,
        cheby_upper: float = 1.1,
        coarse_rtol: float = 1e-8,
        coarse_maxit: int = 30,
        precise_dots: bool = True,
        coarse_op: str = "rediscretize",
        fine_apply=None,
        precond_dtype=None,
    ):
        self.decomp = decomp
        self.mesh_shape = decomp.mesh_shape
        self.nlvls = decomp.nlvls
        self.dof = dof
        self.dtype = dtype
        self.KEs = [jnp.asarray(k, dtype) for k in KEs]
        self.coarse_op = coarse_op
        if coarse_op == "galerkin_octant":
            self.KEps = [None] + [
                jnp.asarray(
                    galerkin_octant_matrices(np.asarray(KEs[l - 1]), dof),
                    dtype,
                )
                for l in range(1, self.nlvls)
            ]
        else:
            self.KEps = [None] * self.nlvls
        self.smooth_sweeps = smooth_sweeps
        self.cheby_lower = cheby_lower
        self.cheby_upper = cheby_upper
        self.coarse_rtol = coarse_rtol
        self.coarse_maxit = coarse_maxit
        self.precise = precise_dots
        # optional fused LOCAL fine-level K@u (ops/select.make_fine_apply
        # built for the local block shape): free BCs, float32 only;
        # halo_accumulate completes it across blocks like the XLA form
        self.fine_apply = fine_apply
        # precond_dtype (bf16): the V-cycle runs on cast copies of the
        # level data, like solvers.multigrid.GeometricMultigrid
        self.precond_dtype = precond_dtype

    # env: per-level dicts of LOCAL arrays:
    #   mask (or None), weights w, origin offsets, and per-solve coef/dinv

    def _raw_apply(self, level, coef, v):
        if level == 0 and self.fine_apply is not None and \
                v.dtype == jnp.float32:
            return self.fine_apply(v, coef)
        if level == 0 or self.coarse_op != "galerkin_octant":
            return apply_hex_operator(v, coef, self.KEs[level])
        return apply_hex_operator_octant(v, coef, self.KEps[level])

    def apply(self, level, env, v):
        lvl = env[level]
        Kv = self._raw_apply(
            level,
            lvl["coef"],
            (lvl["mask"] * v) if lvl["mask"] is not None else v,
        )
        Kv = halo_accumulate(Kv, self.mesh_shape)
        if lvl["mask"] is not None:
            Kv = lvl["mask"] * Kv + (1.0 - lvl["mask"]) * v
        return Kv

    def setup(self, env, scale_fine):
        """Fill per-level coef, dinv, lmax into env (traced).

        lmax: certain Gershgorin bound (see solvers.chebyshev) — the
        absolute row sums are one |KE| matvec + halo accumulate, then a
        pmax over the mesh.
        """
        Es = [scale_fine.astype(self.dtype)]
        for l in range(1, self.nlvls):
            Es.append(coarsen_cell_field(Es[-1]))
        galerkin = self.coarse_op == "galerkin_octant"
        for l in range(self.nlvls):
            lvl = env[l]
            if l == 0 or not galerkin:
                coef = Es[l]
                nn = tuple(s + 1 for s in coef.shape)
                d = hex_operator_diagonal(coef, self.KEs[l], nn)
                R = apply_hex_operator(
                    jnp.ones((*nn, self.dof), self.dtype),
                    coef,
                    jnp.abs(self.KEs[l]),
                )
            else:
                coef = octant_split(Es[l - 1])
                nn = tuple(s + 1 for s in coef.shape[1:])
                d = hex_operator_diagonal_octant(coef, self.KEps[l], nn)
                R = apply_hex_operator_octant(
                    jnp.ones((*nn, self.dof), self.dtype),
                    coef,
                    jnp.abs(self.KEps[l]),
                )
            lvl["coef"] = coef
            d = halo_accumulate(d, self.mesh_shape)
            if lvl["mask"] is not None:
                d = lvl["mask"] * d + (1.0 - lvl["mask"])
            lvl["dinv"] = 1.0 / d
            R = halo_accumulate(R, self.mesh_shape)
            lvl["lmax"] = pmax_scalar(
                gershgorin_lambda_max(R, d, lvl["mask"])
            )
        return env

    def vcycle(self, env, b, level=0):
        lvl = env[level]
        A = partial(self.apply, level, env)

        if level == self.nlvls - 1:
            dot = make_psum_dot(lvl["w"], self.precise)
            res = pcg(
                A,
                b,
                jnp.zeros_like(b),
                M=lambda r: lvl["dinv"] * r,
                rtol=self.coarse_rtol,
                maxiter=self.coarse_maxit,
                flexible=False,
                dot=dot,
            )
            return res.x

        smooth = lambda bb, xx, **kw: chebyshev_smooth(
            A,
            bb,
            xx,
            lvl["dinv"],
            lvl["lmax"],
            degree=self.smooth_sweeps,
            lower=self.cheby_lower,
            upper=self.cheby_upper,
            **kw,
        )
        # presmooth from zero: skip the A(0) application entirely
        x = smooth(b, b, x_is_zero=True)
        r = b - A(x)
        rc = restrict_spmd(r, self.mesh_shape)
        nxt = env[level + 1]
        if nxt["mask"] is not None:
            rc = nxt["mask"] * rc
        ec = self.vcycle(env, rc, level + 1)
        e = prolong_spmd(ec)
        if lvl["mask"] is not None:
            e = lvl["mask"] * e
        x = x + e
        x = smooth(b, x)
        return x

    def preconditioner(self, env):
        """r -> V-cycle(r), in `precond_dtype` when one is set (the outer
        Krylov stays in the field dtype; flexible CG absorbs the
        rounding)."""
        if self.precond_dtype is None:
            return lambda r: self.vcycle(env, r)
        pdt = self.precond_dtype
        cast = [
            {k: v if v is None or k in ("lmax", "offsets")
             else v.astype(pdt) for k, v in lvl.items()}
            for lvl in env
        ]

        def M(r):
            saved = (self.KEs, self.KEps)
            self.KEs = [k.astype(pdt) for k in self.KEs]
            self.KEps = [None if k is None else k.astype(pdt)
                         for k in self.KEps]
            try:
                z = self.vcycle(cast, r.astype(pdt))
            finally:
                self.KEs, self.KEps = saved
            return z.astype(r.dtype)

        return M

    # ------------------------------------------------------------- #
    # host-side: build the blocked static inputs

    def build_static_env(self, masks_global: Optional[List[np.ndarray]]):
        """Blocked numpy arrays for shard_map inputs: per-level mask,
        ownership weights, block origin offsets."""
        np_dt = np.float32 if self.dtype == jnp.float32 else np.float64
        env = []
        for l in range(self.nlvls):
            mask_blk = None
            if masks_global is not None:
                mask_blk = self.decomp.to_blocked_nodal(
                    masks_global[l], level=l
                ).astype(np_dt)
            env.append(
                {
                    "mask": mask_blk,
                    "w": self.decomp.ownership_weights(l, self.dof).astype(
                        np_dt
                    ),
                    "offsets": self.decomp.origin_offsets(l).astype(
                        np.int32
                    ),
                }
            )
        return env


def peel(blocked_local):
    """Inside shard_map each blocked array arrives with leading (1,1,1)
    device dims; strip them."""
    return blocked_local.reshape(blocked_local.shape[3:])


def unpeel(local):
    return local.reshape((1, 1, 1) + local.shape)
