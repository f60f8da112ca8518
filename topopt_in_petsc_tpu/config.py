"""Problem configuration mirroring the reference's PETSc options database.

The reference configures everything through ~25 PETSc CLI flags with defaults
set in TopOpt::SetUp (reference TopOpt.cc:106-135) and read in SetUpMESH /
SetUpOPT (TopOpt.cc:154-165, 323-337) plus the restart flags
(TopOpt.cc:408-450, LinearElasticity.cc:561-585).  This module provides a
typed dataclass with the same names and defaults, and a CLI parser accepting
the same single-dash flags for drop-in comparability.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp

from topopt_in_petsc_tpu.ops.select import IMPLS, resolve_operator


@dataclasses.dataclass
class TopOptConfig:
    """All knobs of the optimization problem + solvers.

    Field names/defaults follow the reference CLI one-to-one
    (TopOpt.cc:106-135):  ``-nx -ny -nz`` are *node* counts, the design grid
    is ``(nx-1, ny-1, nz-1)`` elements.
    """

    # --- FEM mesh (TopOpt.cc:106-117) ---
    nx: int = 65
    ny: int = 33
    nz: int = 33
    xcmin: float = 0.0
    xcmax: float = 2.0
    ycmin: float = 0.0
    ycmax: float = 1.0
    zcmin: float = 0.0
    zcmax: float = 1.0
    nu: float = 0.3
    nlvls: int = 4  # multigrid levels

    # --- Optimization (TopOpt.cc:119-128) ---
    volfrac: float = 0.12
    maxItr: int = 400
    rmin: float = 0.08
    penal: float = 3.0
    Emin: float = 1.0e-9
    Emax: float = 1.0
    filter: int = 1  # 0=sensitivity, 1=density, 2=PDE; other = no filtering
    Xmin: float = 0.0
    Xmax: float = 1.0
    movlim: float = 0.2
    nconstraints: int = 1  # m — reference TopOpt(nconstraints) (TopOpt.cc:15)

    # --- Projection filter (TopOpt.cc:131-135) ---
    projectionFilter: bool = False
    beta: float = 0.1
    betaFinal: float = 48.0
    eta: float = 0.0

    # --- Restart (TopOpt.cc:401-450) ---
    restart: bool = True
    onlyLoadDesign: bool = False
    restartFileVec: str = ""  # here: one .npz per checkpoint stream
    # parity NO-OP: the reference stores itr/fscale in a separate ASCII
    # sidecar (-restartFileItr, TopOpt.cc:552-554); here they live inside
    # the restart .npz, so the flag is accepted and ignored (README).
    restartFileItr: str = ""
    restartFileVecSol: str = ""
    workdir: str = "./"

    # --- Linear solver (LinearElasticity.cc:619-635) ---
    # Outer Krylov: the reference uses FGMRES(100); K is SPD after the
    # symmetric Dirichlet treatment (LinearElasticity.cc:530-538) so we use
    # flexible-PCG by default (short recurrence, few stored vectors).
    ksp_rtol: float = 1.0e-5
    ksp_maxit: int = 200
    # outer Krylov: "fcg" (flexible PCG, the default — K is SPD) or
    # "fgmres" (the reference's own method, LinearElasticity.cc:638-650;
    # robustness fallback, costs (2*restart+1) basis vectors of memory)
    ksp_type: str = "fcg"
    ksp_gmres_restart: int = 30
    coarse_op: str = "rediscretize"  # or "galerkin_octant" (exact
    # level-1 Galerkin; comparable iteration counts, higher per-cycle cost)
    coarse_rtol: float = 1.0e-8
    coarse_maxit: int = 30
    smooth_sweeps: int = 4  # Chebyshev degree per pre/post smooth
    cheby_upper: float = 1.1  # smooth band = [lower*lmax, upper*lmax]
    # (lmax from the certain Gershgorin bound.)
    cheby_lower: float = 0.06

    # --- PDE filter solver (PDEFilter.cc:269-380) ---
    pde_nlvls: int = 3
    pde_rtol: float = 1.0e-8
    pde_maxit: int = 60

    # --- Knobs with no reference equivalent ---
    dtype: str = "float32"  # field dtype: "float32" | "float64"
    # fine-level K@u: "auto" (ops/select.py: the fused kernel on a GPU
    # for float32, the XLA gather form otherwise) or "xla"
    operator_impl: str = "auto"
    # V-cycle storage: "same" (field dtype) | "bfloat16"
    mg_dtype: str = "same"
    precise_dots: bool = True  # upcast CG/objective reductions to f64
    mesh_shape: tuple = (1, 1, 1)  # device mesh (x, y, z); product = #devices
    # run each optimization iteration as ONE compiled program (the SPMD
    # fused step on a 1-device mesh; automatic when mesh_shape != 1,1,1)
    fused: bool = False
    output_cadence_vtu: bool = True  # write .vtu fields like main.cc:114-116
    output_dat: bool = False  # also write the reference-format output_00000.dat
    profile_dir: str = ""  # capture a jax.profiler trace of the run

    # ----------------------------------------------------------------- #

    @property
    def m(self) -> int:
        return self.nconstraints

    @property
    def nelx(self) -> int:
        return self.nx - 1

    @property
    def nely(self) -> int:
        return self.ny - 1

    @property
    def nelz(self) -> int:
        return self.nz - 1

    @property
    def nelem(self) -> int:
        return self.nelx * self.nely * self.nelz

    @property
    def ndof(self) -> int:
        return 3 * self.nx * self.ny * self.nz

    @property
    def dx(self) -> float:
        return (self.xcmax - self.xcmin) / (self.nx - 1)

    @property
    def dy(self) -> float:
        return (self.ycmax - self.ycmin) / (self.ny - 1)

    @property
    def dz(self) -> float:
        return (self.zcmax - self.zcmin) / (self.nz - 1)

    @property
    def jnp_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32

    def validate(self) -> None:
        """MG-compatibility check (reference TopOpt.cc:183-201).

        Every axis must satisfy (n-1) % 2^(nlvls-1) == 0 so the element grid
        can be halved nlvls-1 times.  The reference exit(0)s; we raise.
        """
        div = 2 ** (self.nlvls - 1)
        for name, n in (("x", self.nx), ("y", self.ny), ("z", self.nz)):
            if (n - 1) % div != 0:
                raise ValueError(
                    "MESH DIMENSION NOT COMPATIBLE WITH NUMBER OF MULTIGRID "
                    f"LEVELS: {name} - number of nodes {n} cannot be halved "
                    f"{self.nlvls - 1} times"
                )
        if self.filter == 0 and self.Xmin < 0.001:
            # Prevent division by zero in the sensitivity filter
            # (reference TopOpt.cc:357-359).
            self.Xmin = 0.001
        if self.ksp_type not in ("fcg", "fgmres"):
            raise ValueError(
                f"-ksp_type must be 'fcg' or 'fgmres', got {self.ksp_type}"
            )
        if self.mg_dtype not in ("same", "bfloat16"):
            raise ValueError(
                f"-mg_dtype must be 'same' or 'bfloat16', got {self.mg_dtype}"
            )
        if self.operator_impl not in IMPLS:
            raise ValueError(
                f"-operator_impl must be one of {IMPLS}, "
                f"got {self.operator_impl}"
            )

    # ----------------------------------------------------------------- #
    # CLI (PETSc options style: single-dash long flags; TopOpt.cc:154-165)

    _INT_FLAGS = ("nx", "ny", "nz", "nlvls", "maxItr", "filter", "nconstraints",
                  "ksp_maxit", "smooth_sweeps", "pde_nlvls", "pde_maxit",
                  "coarse_maxit", "ksp_gmres_restart")
    _BOOL_FLAGS = ("projectionFilter", "restart", "onlyLoadDesign",
                   "fused", "precise_dots", "output_cadence_vtu",
                   "output_dat")
    _STR_FLAGS = ("restartFileVec", "restartFileItr", "restartFileVecSol",
                  "workdir", "dtype", "coarse_op", "operator_impl",
                  "mg_dtype", "profile_dir", "ksp_type")

    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "TopOptConfig":
        cfg = cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        i = 0
        argv = list(argv)
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("-"):
                raise ValueError(f"unexpected argument: {tok}")
            name = tok.lstrip("-")
            if name not in fields:
                raise ValueError(f"unknown option: {tok}")
            if i + 1 >= len(argv):
                raise ValueError(f"option {tok} needs a value")
            val = argv[i + 1]
            if name in cls._INT_FLAGS:
                setattr(cfg, name, int(val))
            elif name in cls._BOOL_FLAGS:
                setattr(cfg, name, val.lower() in ("1", "true", "yes", "on"))
            elif name in cls._STR_FLAGS:
                setattr(cfg, name, val)
            elif name == "mesh_shape":
                setattr(cfg, name, tuple(int(v) for v in val.split(",")))
            else:
                setattr(cfg, name, float(val))
            i += 2
        cfg.validate()
        return cfg

    def banner(self) -> str:
        """Config printout equivalent to TopOpt.cc:168-180, 339-353, plus
        the fine-level operator this run resolves to."""
        impl = resolve_operator(self.operator_impl, self.dtype)
        if impl != resolve_operator(self.operator_impl, "float32"):
            impl += f" (the fused kernel is float32-only; dtype={self.dtype})"
        lines = [
            "#" * 62,
            "######################### FEM settings #######################",
            f"# Number of nodes: (-nx,-ny,-nz):        ({self.nx},{self.ny},{self.nz})",
            f"# Number of degree of freedom:           {self.ndof}",
            f"# Number of elements:                    ({self.nelx},{self.nely},{self.nelz})",
            f"# Dimensions: (-xcmin,-xcmax,..,-zcmax): ({self.xcmax - self.xcmin},{self.ycmax - self.ycmin},{self.zcmax - self.zcmin})",
            f"# -nlvls: {self.nlvls}",
            f"# -operator_impl: {impl}",
            "################### Optimization settings ####################",
            f"# Problem size: n= {self.nelem}, m= {self.m}",
            f"# -filter: {self.filter}  (0=sens., 1=dens, 2=PDE)",
            f"# -rmin: {self.rmin}",
            f"# -projectionFilter: {int(self.projectionFilter)}  (0/1)",
            f"# -beta: {self.beta}",
            f"# -betaFinal: {self.betaFinal}",
            f"# -eta: {self.eta}",
            f"# -volfrac: {self.volfrac}",
            f"# -penal: {self.penal}",
            f"# -Emin/-Emax: {self.Emin:e} - {self.Emax:e}",
            f"# -nu: {self.nu}",
            f"# -maxItr: {self.maxItr}",
            f"# -movlim: {self.movlim}",
            "#" * 62,
        ]
        return "\n".join(lines)
