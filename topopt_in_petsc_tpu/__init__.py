"""topopt_in_petsc_tpu — large-scale 3D topology optimization in JAX.

A framework built in JAX/XLA (shard_map + one Pallas kernel for the GPU),
with the capabilities of the PETSc/MPI reference `topopt/TopOpt_in_PETSc`:

- minimum-compliance SIMP optimization on structured hex grids
  (reference: main.cc, TopOpt.cc),
- a matrix-free linear-elasticity solver: PCG preconditioned by geometric
  multigrid with Chebyshev/Jacobi smoothers (reference: LinearElasticity.cc
  FGMRES+PCMG+Galerkin),
- density / sensitivity filters as stencil convolutions and a Helmholtz PDE
  filter reusing the multigrid stack (reference: Filter.cc, PDEFilter.cc),
- smoothed-Heaviside projection with beta continuation (Filter.cc:227-288),
- a fully parallel Method of Moving Asymptotes optimizer with a dual
  interior-point subproblem solver (reference: MMA.cc),
- checkpoint/restart with A/B file flip (TopOpt.cc:514-570) and VTK output
  (MPIIO.cc + bin2vtu_v3.py, emitted directly as .vtu here).

Everything distributed runs over a single `jax.sharding.Mesh` with named axes
('x', 'y', 'z'); fields are block-partitioned over the devices and the SPMD
engine exchanges the halo planes that PETSc's DMDA exchanges in the
reference.
"""

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid

__version__ = "0.1.0"

__all__ = ["TopOptConfig", "Grid", "__version__"]
