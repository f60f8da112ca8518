"""Overlapping-block domain decomposition for the SPMD halo engine.

This is the JAX equivalent of PETSc's DMDA ownership layout
(TopOpt.cc:233-291): the global element grid (ex, ey, ez) splits evenly
over the device mesh (mx, my, mz); each device owns the element block
(ex/mx, ey/my, ez/mz) and carries the *overlapping* nodal block
(ex/mx + 1, ...) — its elements' corner nodes, with the shared planes
duplicated between face neighbors (PETSc's ghost nodes, made explicit).

Blocked storage layout: a global field lives as an array with leading
device axes, e.g. nodal (mx, my, mz, nxl, nyl, nzl, dof), sharded
P('x','y','z') on the leading axes (block size 1 per device — always
divisible, which sidesteps GSPMD's even-split restriction for odd nodal
extents).  `shard_map` peels the leading axes; the interior code sees the
local block.

Conventions:
 - duplicated planes hold IDENTICAL values on both owners ("consistent"
   vectors); every SPMD operation preserves this invariant,
 - a shared plane is *owned* by the lower-coordinate device (it is that
   device's high plane); ownership weights make duplicated nodes count
   once in inner products,
 - element blocks are non-overlapping, so element fields need no masks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from topopt_in_petsc_tpu.grid import Grid


@dataclasses.dataclass(frozen=True)
class BlockDecomp:
    grid: Grid
    mesh_shape: Tuple[int, int, int]
    nlvls: int = 1

    def __post_init__(self):
        for a in range(3):
            e, m = self.grid.ne[a], self.mesh_shape[a]
            if e % m != 0:
                raise ValueError(
                    f"element count {e} (axis {a}) not divisible by mesh "
                    f"dim {m}"
                )
            el = e // m
            if el % (2 ** (self.nlvls - 1)) != 0:
                raise ValueError(
                    f"local element count {el} (axis {a}) not divisible by "
                    f"2^{self.nlvls - 1}; reduce nlvls or mesh dim"
                )

    # -- local shapes per MG level ------------------------------------ #

    def local_ne(self, level: int = 0) -> Tuple[int, int, int]:
        return tuple(
            self.grid.ne[a] // self.mesh_shape[a] // (2**level)
            for a in range(3)
        )

    def local_nn(self, level: int = 0) -> Tuple[int, int, int]:
        return tuple(e + 1 for e in self.local_ne(level))

    def level_grid(self, level: int) -> Grid:
        return self.grid.hierarchy(self.nlvls)[level]

    # -- host-side layout conversions (setup / IO only) --------------- #

    def to_blocked_nodal(self, arr: np.ndarray, level: int = 0):
        """Global (nx, ny, nz, dof) -> blocked
        (mx, my, mz, nxl, nyl, nzl, dof) with overlapping planes."""
        mx, my, mz = self.mesh_shape
        exl, eyl, ezl = self.local_ne(level)
        nxl, nyl, nzl = exl + 1, eyl + 1, ezl + 1
        dof = arr.shape[-1]
        out = np.empty((mx, my, mz, nxl, nyl, nzl, dof), arr.dtype)
        for i in range(mx):
            for j in range(my):
                for k in range(mz):
                    out[i, j, k] = arr[
                        i * exl : i * exl + nxl,
                        j * eyl : j * eyl + nyl,
                        k * ezl : k * ezl + nzl,
                    ]
        return out

    def from_blocked_nodal(self, blocked: np.ndarray, level: int = 0):
        """Inverse of to_blocked_nodal (overlaps must be consistent;
        owned regions are taken)."""
        blocked = np.asarray(blocked)
        mx, my, mz = self.mesh_shape
        exl, eyl, ezl = self.local_ne(level)
        g = self.level_grid(level)
        dof = blocked.shape[-1]
        out = np.empty((*g.nn, dof), blocked.dtype)
        for i in range(mx):
            for j in range(my):
                for k in range(mz):
                    out[
                        i * exl : i * exl + exl + 1,
                        j * eyl : j * eyl + eyl + 1,
                        k * ezl : k * ezl + ezl + 1,
                    ] = blocked[i, j, k]
        return out

    def to_blocked_elem(self, arr: np.ndarray, level: int = 0):
        """Global (ex, ey, ez, ...) -> (mx, my, mz, exl, eyl, ezl, ...)."""
        arr = np.asarray(arr)
        mx, my, mz = self.mesh_shape
        exl, eyl, ezl = self.local_ne(level)
        tail = arr.shape[3:]
        r = arr.reshape(mx, exl, my, eyl, mz, ezl, *tail)
        return np.ascontiguousarray(r.transpose(0, 2, 4, 1, 3, 5,
                                                *range(6, 6 + len(tail))))

    def from_blocked_elem(self, blocked: np.ndarray, level: int = 0):
        blocked = np.asarray(blocked)
        mx, my, mz = self.mesh_shape
        exl, eyl, ezl = self.local_ne(level)
        tail = blocked.shape[6:]
        r = blocked.transpose(0, 3, 1, 4, 2, 5,
                              *range(6, 6 + len(tail)))
        return np.ascontiguousarray(
            r.reshape(mx * exl, my * eyl, mz * ezl, *tail)
        )

    # -- masks --------------------------------------------------------- #

    def ownership_weights(self, level: int, dof: int) -> np.ndarray:
        """Blocked nodal 0/1 weights: 1 iff this device owns the node.

        Owner convention: the low plane of a block is owned by the lower
        neighbor, except at the global boundary (device index 0).
        """
        mx, my, mz = self.mesh_shape
        nxl, nyl, nzl = self.local_nn(level)
        out = np.ones((mx, my, mz, nxl, nyl, nzl, dof))
        out[1:, :, :, 0, :, :, :] = 0.0
        out[:, 1:, :, :, 0, :, :] = 0.0
        out[:, :, 1:, :, :, 0, :] = 0.0
        return out

    def center_weights(self, level: int, dof: int) -> np.ndarray:
        """Same as ownership_weights — the restriction center-term weights
        (kept as a separate name for clarity at call sites)."""
        return self.ownership_weights(level, dof)

    def origin_offsets(self, level: int = 0) -> np.ndarray:
        """(mx, my, mz, 3) global node index of each block origin."""
        mx, my, mz = self.mesh_shape
        exl, eyl, ezl = self.local_ne(level)
        i, j, k = np.meshgrid(
            np.arange(mx) * exl,
            np.arange(my) * eyl,
            np.arange(mz) * ezl,
            indexing="ij",
        )
        return np.stack([i, j, k], axis=-1)
