"""Flexible GMRES (restarted) — the reference's outer Krylov method.

The reference solves the state equation with FGMRES(100) + PCMG
(LinearElasticity.cc:638-650).  This framework defaults to flexible PCG
(solvers/cg.py) because K is SPD and short recurrences keep only 4
vectors in device memory; FGMRES is kept as the robustness fallback behind
`-ksp_type fgmres` for operating points where FCG might stall (extreme
SIMP contrast + aggressive beta projection), mirroring the reference's
solver choice exactly.

Right-preconditioned flexible Arnoldi (Saad, Iterative Methods §9.4.1):
the preconditioner may change between iterations (our V-cycle contains a
coarse CG solve), so the Z basis of preconditioned vectors is stored and
the correction is x += Z y.  Basis arrays are statically shaped
(restart+1, ...) and the inner loop is a `lax.while_loop` with masked
modified-Gram-Schmidt — fully jit-compatible, no host syncs.

Memory: (2*restart+1) nodal vectors, vs 4 for FCG — the reason FCG is
the default (SURVEY §7.1).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from topopt_in_petsc_tpu.solvers.cg import CGResult, _dot


def fgmres(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    M: Callable[[jax.Array], jax.Array] | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 200,
    restart: int = 30,
    precise_dots: bool = True,
    dot: Callable | None = None,
) -> CGResult:
    """Solve A x = b with FGMRES(restart); same contract as `pcg`.

    Matches the reference solver settings (LinearElasticity.cc:619-650):
    nonzero initial guess, relative tolerance on ||r|| / ||b||, maxiter
    counting total Krylov iterations across restarts.
    """
    if M is None:
        M = lambda r: r
    if dot is None:
        dot = partial(_dot, precise=precise_dots)

    shape, dtype = b.shape, b.dtype
    m = restart

    def norm(v):
        return jnp.sqrt(dot(v, v))

    bnorm = norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    class Outer(NamedTuple):
        x: jax.Array
        rnorm: jax.Array
        k: jax.Array  # total iterations

    class Inner(NamedTuple):
        V: jax.Array  # (m+1, *shape) Krylov basis
        Z: jax.Array  # (m,   *shape) preconditioned basis
        H: jax.Array  # (m+1, m) Hessenberg (Givens-triangularized in place)
        cs: jax.Array  # (m,) Givens cosines
        sn: jax.Array  # (m,) Givens sines
        g: jax.Array  # (m+1,) rotated rhs; |g[j+1]| = current residual
        j: jax.Array
        res: jax.Array
        k: jax.Array

    def inner_cond(s: Inner):
        return jnp.logical_and(
            s.j < m, jnp.logical_and(s.res > tol, s.k < maxiter)
        )

    def inner_body(s: Inner):
        j = s.j
        vj = jnp.take(s.V, j, axis=0)
        zj = M(vj)
        w = A(zj)
        # masked modified Gram-Schmidt against rows 0..j of V
        idx = jnp.arange(m + 1)

        def mgs(i, carry):
            w, h = carry
            vi = jnp.take(s.V, i, axis=0)
            hi = jnp.where(i <= j, dot(w, vi).astype(dtype), 0.0)
            w = w - hi * vi
            return (w, h.at[i].set(hi))

        w, h = jax.lax.fori_loop(
            0, m + 1, lambda i, c: jax.lax.cond(
                i <= j, lambda c: mgs(i, c), lambda c: c, c
            ),
            (w, jnp.zeros((m + 1,), dtype)),
        )
        hj1 = norm(w).astype(dtype)
        w = w / jnp.where(hj1 > 0, hj1, 1.0)
        h = h.at[j + 1].set(hj1)

        # apply previous Givens rotations to the new column
        def rot(i, h):
            hi = jnp.take(h, i)
            hi1 = jnp.take(h, i + 1)
            ci = jnp.take(s.cs, i)
            si = jnp.take(s.sn, i)
            h = h.at[i].set(ci * hi + si * hi1)
            h = h.at[i + 1].set(-si * hi + ci * hi1)
            return h

        h = jax.lax.fori_loop(
            0, m, lambda i, hh: jax.lax.cond(
                i < j, lambda hh: rot(i, hh), lambda hh: hh, hh
            ),
            h,
        )
        # new rotation eliminating h[j+1]
        a0 = jnp.take(h, j)
        a1 = jnp.take(h, j + 1)
        r = jnp.sqrt(a0 * a0 + a1 * a1)
        cj = jnp.where(r > 0, a0 / jnp.where(r > 0, r, 1.0), 1.0)
        sj = jnp.where(r > 0, a1 / jnp.where(r > 0, r, 1.0), 0.0)
        h = h.at[j].set(r).at[j + 1].set(0.0)
        gj = jnp.take(s.g, j)
        g = s.g.at[j].set(cj * gj).at[j + 1].set(-sj * gj)

        return Inner(
            V=jax.lax.dynamic_update_index_in_dim(s.V, w, j + 1, 0),
            Z=jax.lax.dynamic_update_index_in_dim(s.Z, zj, j, 0),
            H=jax.lax.dynamic_update_index_in_dim(s.H, h, j, 1),
            cs=s.cs.at[j].set(cj),
            sn=s.sn.at[j].set(sj),
            g=g,
            j=j + 1,
            res=jnp.abs(jnp.take(g, j + 1)).astype(s.res.dtype),
            k=s.k + 1,
        )

    def outer_body(o: Outer):
        r = b - A(o.x)
        beta = norm(r).astype(dtype)
        v0 = r / jnp.where(beta > 0, beta, 1.0)
        V = jnp.zeros((m + 1, *shape), dtype)
        V = jax.lax.dynamic_update_index_in_dim(V, v0, 0, 0)
        init = Inner(
            V=V,
            Z=jnp.zeros((m, *shape), dtype),
            H=jnp.zeros((m + 1, m), dtype),
            cs=jnp.zeros((m,), dtype),
            sn=jnp.zeros((m,), dtype),
            g=jnp.zeros((m + 1,), dtype).at[0].set(beta),
            j=jnp.asarray(0, jnp.int32),
            res=beta.astype(jnp.float64)
            if o.rnorm.dtype == jnp.float64
            else beta,
            k=o.k,
        )
        s = jax.lax.while_loop(inner_cond, inner_body, init)

        # back-substitute R y = g on the active j x j block: inactive
        # columns get unit diagonal and zero rhs, so y[j'] = 0 there.
        jj = s.j
        col = jnp.arange(m)
        active = col < jj
        R = jnp.where(
            (col[None, :] >= col[:, None]) & active[None, :] & (
                col[:, None] < jj
            ),
            s.H[:m, :],
            jnp.where(
                jnp.eye(m, dtype=bool), jnp.asarray(1.0, dtype), 0.0
            ),
        )
        gv = jnp.where(active, s.g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(R, gv, lower=False)
        dx = jnp.tensordot(y, s.Z, axes=1)
        return Outer(x=o.x + dx, rnorm=s.res, k=s.k)

    def outer_cond(o: Outer):
        return jnp.logical_and(o.k < maxiter, o.rnorm > tol)

    r0 = norm(b - A(x0))
    out = jax.lax.while_loop(
        outer_cond, outer_body,
        Outer(x=x0, rnorm=r0, k=jnp.asarray(0, jnp.int32)),
    )
    return CGResult(
        x=out.x,
        iters=out.k,
        relres=out.rnorm / jnp.maximum(bnorm, 1e-300),
    )
