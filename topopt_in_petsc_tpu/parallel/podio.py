"""Multi-host-safe host<->device transfers for the SPMD driver.

On multi-host JAX a globally-sharded array's shards are NOT all
addressable from one process: `np.asarray(global)` raises, and
`jax.device_put(host_global, NamedSharding)` cannot place
non-addressable shards.  These helpers keep the single-host fast path
byte-identical while giving every SpmdDriver IO call site a
multi-host-correct form — the role of the reference's collective MPI-IO
(MPIIO.cc:380-714, `MPI_File_write_all` from every rank) and of its
restart readers (TopOpt.cc:514-570):

- `gather_blocked(arr, ...)`: blocked global -> full numpy array on the
  PRIMARY process only (None elsewhere).  Fully-addressable arrays
  (single host) assemble directly from their shards in memory.
  Multi-host arrays hop through per-process shard dumps in a shared
  scratch directory plus a primary-side stitch, with
  `multihost_utils.sync_global_devices` barriers — no non-primary
  process ever materializes the full array on its host.
- `put_blocked(host_global, sharding)`: build the global sharded array
  via `jax.make_array_from_callback`, which asks each process only for
  its ADDRESSABLE blocks — the multi-host-safe inverse for restart loads
  (every process must be able to read the checkpoint file, as with the
  reference's PetscViewer loads).

The shard-dump branch assumes the scratch directory is visible to all
hosts (a shared filesystem — the reference's MPI-IO makes the same
assumption about its output path).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from topopt_in_petsc_tpu.parallel.multihost import is_primary


def _barrier(tag: str) -> None:
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(tag)


_NONCE: list = []


def _run_nonce() -> str:
    """Per-run identifier agreed across all processes (process 0's
    random draw, broadcast once).  Shard-dump filenames carry it so a
    relaunch under the same workdir can never stitch stale dumps left
    by a crashed previous run (possibly with a different process
    count)."""
    if not _NONCE:
        import secrets

        from jax.experimental import multihost_utils

        mine = np.frombuffer(secrets.token_bytes(4), np.uint32)[0]
        agreed = int(
            multihost_utils.broadcast_one_to_all(np.uint32(mine))
        )
        _NONCE.append(f"{agreed:08x}")
    return _NONCE[0]


def local_blocks(arr) -> list[tuple[tuple, np.ndarray]]:
    """[(global_index_tuple, block_numpy)] for this process's
    addressable shards only — never touches remote shards."""
    out = []
    for sh in arr.addressable_shards:
        out.append((sh.index, np.asarray(sh.data)))
    return out


def gather_blocked(
    arr,
    *,
    scratch_dir: Optional[str] = None,
    tag: str = "field",
    force_dump: bool = False,
) -> Optional[np.ndarray]:
    """Global numpy from a sharded blocked array, on the primary
    process (None on others).

    Single host (fully addressable): in-memory shard assembly, no
    files.  Multi-host (or `force_dump=True`, for tests): each process
    dumps its addressable blocks to `scratch_dir`, the primary stitches
    after a barrier.  COLLECTIVE in the multi-host branch — call from
    every process.
    """
    if arr.is_fully_addressable and not force_dump:
        out = np.empty(arr.shape, arr.dtype)
        for idx, blk in local_blocks(arr):
            out[idx] = blk
        return out

    if scratch_dir is None:
        raise ValueError(
            "gather_blocked on a non-addressable array needs a shared "
            "scratch_dir"
        )
    os.makedirs(scratch_dir, exist_ok=True)
    pidx = jax.process_index()
    nonce = _run_nonce()
    path = os.path.join(
        scratch_dir, f"{tag}.{nonce}.proc{pidx:05d}.npz"
    )
    blocks = local_blocks(arr)
    np.savez(
        path,
        n=np.int64(len(blocks)),
        **{
            f"blk{i}": blk for i, (_, blk) in enumerate(blocks)
        },
        **{
            # slice -> (start, stop) per axis; None bounds resolve
            # against the global shape
            f"idx{i}": np.asarray(
                [
                    (
                        0 if s.start is None else s.start,
                        arr.shape[a] if s.stop is None else s.stop,
                    )
                    for a, s in enumerate(idx)
                ],
                np.int64,
            )
            for i, (idx, _) in enumerate(blocks)
        },
    )
    if not force_dump:
        _barrier(f"podio_gather_{tag}_dump")
    if not is_primary():
        if not force_dump:
            _barrier(f"podio_gather_{tag}_stitch")
        return None
    # the stitch MUST reach its barrier even when it raises (holes /
    # corrupt file): otherwise every non-primary process deadlocks in
    # sync_global_devices while only the primary sees the error
    err = None
    out = np.empty(arr.shape, arr.dtype)
    filled = np.zeros(arr.shape[:3], bool)  # leading device axes
    try:
        prefix = f"{tag}.{nonce}.proc"
        for fn in sorted(os.listdir(scratch_dir)):
            if fn.startswith(tag + ".") and not (
                fn.startswith(prefix) and fn.endswith(".npz")
            ):
                # stale dump from a previous (crashed) run under the
                # same workdir: a different nonce — remove, never stitch
                os.remove(os.path.join(scratch_dir, fn))
                continue
            if not fn.startswith(prefix):
                continue
            with np.load(os.path.join(scratch_dir, fn)) as z:
                for i in range(int(z["n"])):
                    bounds = z[f"idx{i}"]
                    sl = tuple(
                        slice(int(a), int(b)) for a, b in bounds
                    )
                    out[sl] = z[f"blk{i}"]
                    filled[sl[:3]] = True
            os.remove(os.path.join(scratch_dir, fn))
        if not bool(filled.all()):
            raise RuntimeError(
                f"gather_blocked({tag}): stitched output has holes — "
                "missing shard dumps (scratch_dir not shared across "
                "hosts?)"
            )
    except Exception as e:  # noqa: BLE001
        err = e
    if not force_dump:
        _barrier(f"podio_gather_{tag}_stitch")
    if err is not None:
        raise err
    return out


def put_blocked(host_global: np.ndarray, sharding) -> jax.Array:
    """Host global -> sharded device array without a host-global
    device_put: `make_array_from_callback` requests only the blocks
    addressable from this process."""
    host_global = np.asarray(host_global)
    return jax.make_array_from_callback(
        host_global.shape, sharding, lambda idx: host_global[idx]
    )


