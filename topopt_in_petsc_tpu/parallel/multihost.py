"""Multi-process initialization (the reference's `mpirun -np N` launch,
README.md:29, as single-program multi-process JAX).

Start the same CLI once per process with JAX's own variables set:

    JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=2 \\
    JAX_PROCESS_ID=<0|1> python -m topopt_in_petsc_tpu -mesh_shape 2,2,2 ...

The ('x','y','z') device mesh then spans all processes; the SPMD halo
engine's ppermute plane exchanges run wherever `make_device_mesh` puts
neighbouring blocks.  Without `JAX_COORDINATOR_ADDRESS` the run is a
single process and nothing is initialized.

Host-side IO (VTU/restart gathers in SpmdDriver) runs on process 0 only.
"""

from __future__ import annotations

import os

import jax


def initialize() -> None:
    """Join the multi-process job described by the environment; no-op
    for a single process."""
    address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not address:
        return
    jax.distributed.initialize(
        coordinator_address=address,
        num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
        process_id=int(os.environ["JAX_PROCESS_ID"]),
    )


def is_primary() -> bool:
    return jax.process_index() == 0
