"""Multi-process-safe IO helpers (parallel/podio.py): gathers that assemble from
addressable shards only, restart puts via make_array_from_callback —
the multi-host-correct forms of SpmdDriver's IO (MPIIO.cc:380-714,
TopOpt.cc:514-570), validated on the 8-virtual-device CPU mesh."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.parallel import podio
from topopt_in_petsc_tpu.parallel.decomp import BlockDecomp
from topopt_in_petsc_tpu.parallel.mesh import make_device_mesh
from topopt_in_petsc_tpu.parallel.spmd import AXIS_NAMES

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

MESH_SHAPE = (2, 2, 2)
NN = (17, 9, 9)


def _blocked_nodal():
    grid = Grid(nn=NN, lo=(0, 0, 0), hi=(2, 1, 1))
    d = BlockDecomp(grid, MESH_SHAPE, nlvls=1)
    mesh = make_device_mesh(MESH_SHAPE)
    rng = np.random.default_rng(3)
    u = rng.normal(size=(*NN, 3)).astype(np.float32)
    blk_np = d.to_blocked_nodal(u)
    sharding = NamedSharding(mesh, P(*AXIS_NAMES))
    return u, blk_np, jax.device_put(blk_np, sharding), d, sharding


def test_gather_blocked_addressable_matches_asarray():
    """Single-host fast path: shard assembly == np.asarray, and the
    decomp inverse recovers the global field."""
    u, blk_np, blk, d, _ = _blocked_nodal()
    g = podio.gather_blocked(blk)
    np.testing.assert_array_equal(g, blk_np)
    np.testing.assert_array_equal(d.from_blocked_nodal(g), u)


def test_gather_blocked_dump_stitch_roundtrip(tmp_path):
    """The multi-host branch (forced): per-process shard dump + primary
    stitch reproduces the in-memory gather exactly."""
    _, blk_np, blk, _, _ = _blocked_nodal()
    g = podio.gather_blocked(
        blk, scratch_dir=str(tmp_path), tag="t", force_dump=True
    )
    np.testing.assert_array_equal(g, blk_np)
    # shard dumps are consumed by the stitch
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]


def test_gather_blocked_nonprimary_no_materialization(
    tmp_path, monkeypatch
):
    """A non-primary process dumps its addressable blocks and returns
    None — it never allocates the global array on its host."""
    _, _, blk, _, _ = _blocked_nodal()
    monkeypatch.setattr(podio, "is_primary", lambda: False)
    empties = []
    real_empty = np.empty

    def spy_empty(shape, *a, **k):
        empties.append(tuple(np.atleast_1d(shape)))
        return real_empty(shape, *a, **k)

    monkeypatch.setattr(np, "empty", spy_empty)
    g = podio.gather_blocked(
        blk, scratch_dir=str(tmp_path), tag="t", force_dump=True
    )
    assert g is None
    # the dump file for the (sole) process exists for the primary to
    # stitch; no global-shaped allocation happened here
    assert [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert all(e != tuple(blk.shape) for e in empties)


def test_gather_blocked_detects_holes(tmp_path, monkeypatch):
    """A stitched output with missing shard dumps (unshared scratch
    dir) fails loudly instead of returning garbage."""
    _, _, blk, _, _ = _blocked_nodal()
    real_savez = np.savez

    def half_savez(path, **kw):
        # simulate another host's dump never landing: drop half the
        # blocks from this process's file
        n = int(kw["n"])
        keep = {"n": np.int64(n // 2)}
        for i in range(n // 2):
            keep[f"blk{i}"] = kw[f"blk{i}"]
            keep[f"idx{i}"] = kw[f"idx{i}"]
        real_savez(path, **keep)

    monkeypatch.setattr(np, "savez", half_savez)
    with pytest.raises(RuntimeError, match="holes"):
        podio.gather_blocked(
            blk, scratch_dir=str(tmp_path), tag="t", force_dump=True
        )


def test_put_blocked_matches_device_put():
    _, blk_np, blk_ref, _, sharding = _blocked_nodal()
    got = podio.put_blocked(blk_np, sharding)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(blk_ref))
    assert got.sharding == blk_ref.sharding


def test_gather_blocked_ignores_stale_dumps(tmp_path):
    """Dump files left by a previous (crashed) run — a different run
    nonce — are removed, never stitched into the output."""
    _, blk_np, blk, _, _ = _blocked_nodal()
    stale = tmp_path / "t.deadbeef.proc00007.npz"
    np.savez(
        str(stale),
        n=np.int64(1),
        blk0=np.full_like(blk_np[0, 0, 0], 777.0),
        idx0=np.asarray(
            [(0, 1), (0, 1), (0, 1)]
            + [(0, s) for s in blk_np.shape[3:]],
            np.int64,
        ),
    )
    g = podio.gather_blocked(
        blk, scratch_dir=str(tmp_path), tag="t", force_dump=True
    )
    np.testing.assert_array_equal(g, blk_np)  # stale 777s not stitched
    assert not stale.exists()  # and cleaned up
