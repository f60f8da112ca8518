"""Parallel Method of Moving Asymptotes with dual interior-point solver.

JAX re-implementation of the reference MMA class (MMA.{h,cc}), the
distributed MMA of Aage & Lazarov (2013), SMO 47(4):493-505:

  per Update (MMA.cc:499-518):
    1. GenSub (MMA.cc:522-649): moving asymptotes L/U via the oscillation
       heuristic, subproblem bounds alpha/beta, separable convex
       approximation coefficients p0/q0/pij/qij, constraint constants b.
    2. Solve the *dual* over lambda in R^m with a dense interior-point
       Newton method (MMA.cc:651-946): XYZofLAMBDA -> DualGrad -> DualHess
       -> dense solve -> line search -> residual, over a decreasing
       epsilon path 1 -> 1e-9 sqrt(m+n).

All O(n) work is elementwise over the (sharded) design array with m-sized
cross-device reductions (the reference's MPI_Allreduce sites at MMA.cc:626,
764, 834, 925 become jnp sums that XLA turns into psums); the m x m dual
Newton system is replicated.  The entire Update runs as one jitted function
with `lax.while_loop`s, no host round-trips.

Design arrays keep their natural (ex, ey, ez) shape; m is static.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _rsum(x, precise: bool):
    """Reduction over all design dofs (f64 accumulate when precise)."""
    if precise and x.dtype != jnp.float64:
        return jnp.sum(x, dtype=jnp.float64)
    return jnp.sum(x)


class MMAState(NamedTuple):
    """Persistent optimizer state (the restart set, TopOpt.cc:523)."""

    L: jax.Array  # lower asymptotes, design shape
    U: jax.Array  # upper asymptotes
    xo1: jax.Array  # design at iteration k-1
    xo2: jax.Array  # design at iteration k-2
    k: int  # GenSub call count (static int, host-side)


class MMA:
    """m-constraint MMA over an n-dof design field."""

    def __init__(
        self,
        n: int,
        m: int,
        shape: Tuple[int, ...],
        dtype=jnp.float32,
        a: Optional[np.ndarray] = None,
        c: Optional[np.ndarray] = None,
        d: Optional[np.ndarray] = None,
        *,
        asyminit: float = 0.5,
        asymdec: float = 0.7,
        asyminc: float = 1.2,
        robust_asymptotes_type: int = 0,
        constraint_modification: bool = False,
        precise_dots: bool = True,
        max_outer_levels: int = 32,
        reduce_sum=None,
        reduce_max=None,
        reduce_matrix=None,
    ):
        self.n = n
        self.m = m
        self.shape = shape
        self.dtype = dtype
        # Default subproblem penalties (MMA.cc:128-132 / TopOpt.cc:394-398).
        self.a = jnp.asarray(
            a if a is not None else np.zeros(m), dtype=dtype
        )
        self.c = jnp.asarray(
            c if c is not None else np.full(m, 1000.0), dtype=dtype
        )
        self.d = jnp.asarray(
            d if d is not None else np.zeros(m), dtype=dtype
        )
        self.asyminit = asyminit
        self.asymdec = asymdec
        self.asyminc = asyminc
        self.robust_type = robust_asymptotes_type
        self.constraint_modification = constraint_modification
        self.precise = precise_dots
        self.max_outer_levels = max_outer_levels
        # Reduction hooks: the SPMD engine passes psum-completing versions
        # (the reference's MPI_Allreduce sites, MMA.cc:626, 764, 834, 925).
        self._sum = reduce_sum or (lambda v: _rsum(v, self.precise))
        self._maxr = reduce_max or jnp.max
        self._matsum = reduce_matrix or (lambda H: H)

        z = jnp.zeros(shape, dtype=dtype)
        self.state = MMAState(L=z, U=z, xo1=z, xo2=z, k=0)
        # multipliers of the last subproblem (for KKT residual)
        self.lam = jnp.zeros((m,), dtype=dtype)
        self.y = jnp.zeros((m,), dtype=dtype)
        self.z = jnp.asarray(0.0, dtype=dtype)

        self._jit_update = jax.jit(self._update_impl)
        self._jit_movelimit = jax.jit(self._movelimit_impl)
        self._jit_change = jax.jit(self._design_change_impl)

    # -------------------------------------------------------------- #
    # Public API mirroring MMA.h:44-73

    @classmethod
    def from_restart(cls, n, m, shape, dtype, k, xo1, xo2, U, L, **kw):
        """Restart constructor (MMA.cc:22-106)."""
        mma = cls(n, m, shape, dtype, **kw)
        if k < 3:
            print("NOT A LEGAL RESTART POINT (k<3): EXPECT BREAKDOWN")
        mma.state = MMAState(
            L=jnp.asarray(L, dtype),
            U=jnp.asarray(U, dtype),
            xo1=jnp.asarray(xo1, dtype),
            xo2=jnp.asarray(xo2, dtype),
            k=int(k),
        )
        return mma

    def set_asymptotes(self, init, decrease, increase):
        """SetAsymptotes (MMA.cc:362-370)."""
        self.asyminit, self.asymdec, self.asyminc = init, decrease, increase

    def set_robust_asymptotes_type(self, val):
        """SetRobustAsymptotesType (MMA.cc:372-384)."""
        if val in (0, 1):
            self.robust_type = val
        else:
            print(f"ERROR: RobustAsymptotesType cannot be set to: {val}")

    def constraint_modification_on(self, flag: bool):
        self.constraint_modification = bool(flag)

    def restart_vectors(self):
        """Restart export (MMA.cc:319-359): (xo1, xo2, U, L)."""
        s = self.state
        return s.xo1, s.xo2, s.U, s.L

    def set_outer_movelimit(self, Xmin, Xmax, movlim, x):
        """SetOuterMovelimit (MMA.cc:386-405): returns (xmin, xmax)."""
        return self._jit_movelimit(
            x, jnp.asarray(Xmin, self.dtype), jnp.asarray(Xmax, self.dtype),
            jnp.asarray(movlim, self.dtype)
        )

    def _movelimit_impl(self, x, Xmin, Xmax, movlim):
        xmax = jnp.minimum(Xmax, x + movlim)
        xmin = jnp.maximum(Xmin, x - movlim)
        return xmin, xmax

    def design_change(self, x, xold):
        """DesignChange (MMA.cc:407-426): inf-norm of x - xold.
        Returns (ch, x) — caller stores x as the new xold."""
        ch = self._jit_change(x, xold)
        return float(ch), x

    def _design_change_impl(self, x, xold):
        return self._maxr(jnp.abs(x - xold))

    def update(self, x, dfdx, gx, dgdx, xmin, xmax):
        """Update (MMA.cc:499-518): generate + solve subproblem, advance
        history.  Returns the new design."""
        fresh = self.state.k < 2  # GenSub does k++ then tests k<3
        x_new, L, U, lam, y, z = self._jit_update(
            x.astype(self.dtype),
            dfdx.astype(self.dtype),
            gx.astype(self.dtype),
            dgdx.astype(self.dtype),
            xmin.astype(self.dtype),
            xmax.astype(self.dtype),
            self.state.L,
            self.state.U,
            self.state.xo1,
            self.state.xo2,
            fresh_asymptotes=jnp.asarray(fresh),
        )
        self.state = MMAState(
            L=L, U=U, xo1=x, xo2=self.state.xo1, k=self.state.k + 1
        )
        self.lam, self.y, self.z = lam, y, z
        return x_new

    # -------------------------------------------------------------- #
    # Subproblem generation (GenSub, MMA.cc:522-649)

    def _gensub(self, x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2,
                fresh_asymptotes):
        """`fresh_asymptotes` is a boolean scalar (traced or not), so one
        compiled program serves every iteration."""
        dt = self.dtype
        helpvar = (x - xo1) * (xo1 - xo2)
        gamma = jnp.where(
            helpvar < 0.0,
            self.asymdec,
            jnp.where(helpvar > 0.0, self.asyminc, 1.0),
        ).astype(dt)
        La = x - gamma * (xo1 - L)
        Ua = x + gamma * (U - xo1)
        xmi = jnp.maximum(1.0e-5, xmax - xmin)
        if self.robust_type == 0:
            La = jnp.clip(La, x - 10.0 * xmi, x - 0.01 * xmi)
            Ua = jnp.clip(Ua, x + 0.01 * xmi, x + 10.0 * xmi)
        else:  # type 1 (MMA.cc:574-589)
            La = jnp.clip(La, x - 100.0 * xmi, x - 1.0e-4 * xmi)
            Ua = jnp.clip(Ua, x + 1.0e-4 * xmi, x + 100.0 * xmi)
            xlo = xmin - 1.0e-5
            xhi = xmax + 1.0e-5
            La = jnp.where(x < xlo, x - (xhi - x) / 0.9, La)
            Ua = jnp.where(x < xlo, x + (xhi - x) / 0.9, Ua)
            La = jnp.where(x > xhi, x - (x - xlo) / 0.9, La)
            Ua = jnp.where(x > xhi, x + (x - xlo) / 0.9, Ua)
        # fresh asymptotes while k < 3 (MMA.cc:532-537)
        span = self.asyminit * (xmax - xmin)
        L = jnp.where(fresh_asymptotes, x - span, La)
        U = jnp.where(fresh_asymptotes, x + span, Ua)

        alpha = jnp.maximum(xmin, 0.9 * L + 0.1 * x)
        beta = jnp.minimum(xmax, 0.9 * U + 0.1 * x)

        feps = 1.0e-6
        Ux2 = (U - x) ** 2
        xL2 = (x - L) ** 2
        reg = 0.001 * jnp.abs(dfdx) + 0.5 * feps / (U - L)
        p0 = Ux2 * (jnp.maximum(0.0, dfdx) + reg)
        q0 = xL2 * (jnp.maximum(0.0, -dfdx) + reg)

        if self.constraint_modification:
            regc = 0.001 * jnp.abs(dgdx) + 0.5 * feps / (U - L)[None]
            pij = Ux2[None] * (jnp.maximum(0.0, dgdx) + regc)
            qij = xL2[None] * (jnp.maximum(0.0, -dgdx) + regc)
        else:
            pij = Ux2[None] * jnp.maximum(0.0, dgdx)
            qij = xL2[None] * jnp.maximum(0.0, -dgdx)

        b = jnp.stack(
            [
                self._sum(pij[j] / (U - x) + qij[j] / (x - L))
                for j in range(self.m)
            ]
        ).astype(dt) - gx

        return L, U, alpha, beta, p0, q0, pij, qij, b

    # -------------------------------------------------------------- #
    # Dual interior point (SolveDIP, MMA.cc:651-688)

    def _xyz_of_lambda(self, lam, sub):
        """x(lambda), y(lambda), z(lambda) (MMA.cc:690-740)."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        lam = jnp.maximum(lam, 0.0)
        y = jnp.maximum(0.0, lam - self.c)
        lamai = jnp.sum(lam * self.a)
        z = jnp.maximum(0.0, 10.0 * (lamai - 1.0))  # a0 = 1.0
        pjlam = p0 + jnp.tensordot(lam, pij, axes=1)
        qjlam = q0 + jnp.tensordot(lam, qij, axes=1)
        sp = jnp.sqrt(pjlam)
        sq = jnp.sqrt(qjlam)
        x = (sp * L + sq * U) / (sp + sq)
        x = jnp.clip(x, alpha, beta)
        return x, y, z, lam

    def _dual_grad(self, x, y, z, sub):
        """(MMA.cc:742-777)."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        g = jnp.stack(
            [
                self._sum(pij[j] / (U - x) + qij[j] / (x - L))
                for j in range(self.m)
            ]
        ).astype(self.dtype)
        return g - b - self.a * z - y

    def _dual_hess(self, x, lam, mu, sub):
        """(MMA.cc:779-880)."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        lam = jnp.maximum(lam, 0.0)
        pjlam = p0 + jnp.tensordot(lam, pij, axes=1)
        qjlam = q0 + jnp.tensordot(lam, qij, axes=1)
        Ux = U - x
        xL = x - L
        PQ = pij / Ux[None] ** 2 - qij / xL[None] ** 2  # (m, ...)
        df2 = -1.0 / (2.0 * pjlam / Ux**3 + 2.0 * qjlam / xL**3)
        sp = jnp.sqrt(pjlam)
        sq = jnp.sqrt(qjlam)
        xp = (sp * L + sq * U) / (sp + sq)
        df2 = jnp.where((xp < alpha) | (xp > beta), 0.0, df2)

        PQf = PQ.reshape(self.m, -1)
        w = (PQf * df2.reshape(1, -1)).astype(
            jnp.float64 if self.precise else self.dtype
        )
        Hess = self._matsum(
            (w @ PQf.astype(w.dtype).T).astype(self.dtype)
        )

        lamai = jnp.sum(lam * self.a)
        diag_corr = jnp.where(lam > self.c, -1.0, 0.0) - mu / jnp.maximum(
            lam, 1e-300
        )
        Hess = Hess + jnp.diag(diag_corr)
        Hess = Hess + jnp.where(
            lamai > 0.0, -10.0 * jnp.outer(self.a, self.a), 0.0
        )
        # diagonal regularization (MMA.cc:856-866)
        trace = jnp.trace(Hess)
        corr = 1e-4 * trace / self.m
        corr = jnp.where(-corr < 1.0e-7, -1.0e-7, corr)
        Hess = Hess + corr * jnp.eye(self.m, dtype=self.dtype)
        return Hess, lam

    def _dual_residual(self, x, y, z, lam, mu, epsi, sub):
        """(MMA.cc:902-946): inf-norm of the 2m dual KKT residuals."""
        L, U, alpha, beta, p0, q0, pij, qij, b = sub
        res1 = jnp.stack(
            [
                self._sum(pij[j] / (U - x) + qij[j] / (x - L))
                for j in range(self.m)
            ]
        ).astype(self.dtype)
        res1 = res1 - b - self.a * z - y + mu
        res2 = mu * lam - epsi
        return jnp.maximum(
            jnp.max(jnp.abs(res1)), jnp.max(jnp.abs(res2))
        )

    def _solve_dip(self, sub):
        """Dual interior point over the epsilon path (MMA.cc:651-688)."""
        dt = self.dtype
        m = self.m
        lam0 = self.c / 2.0
        mu0 = jnp.ones((m,), dt)
        tol = 1.0e-9 * np.sqrt(m + self.n)

        def newton_step(lam, mu, epsi):
            x, y, z, lam = self._xyz_of_lambda(lam, sub)
            grad = self._dual_grad(x, y, z, sub)
            grad = -grad - epsi / lam
            Hess, lam = self._dual_hess(x, lam, mu, sub)
            if m == 1:
                s_lam = grad / Hess[0, 0]
            else:
                s_lam = jnp.linalg.solve(Hess, grad)
            s_mu = -mu + epsi / lam - s_lam * mu / lam
            # line search (MMA.cc:882-900)
            theta = jnp.maximum(
                1.005,
                jnp.maximum(
                    jnp.max(-1.01 * s_lam / lam), jnp.max(-1.01 * s_mu / mu)
                ),
            )
            step = 1.0 / theta
            lam = lam + step * s_lam
            mu = mu + step * s_mu
            x, y, z, lam_cl = self._xyz_of_lambda(lam, sub)
            err = self._dual_residual(x, y, z, lam_cl, mu, epsi, sub)
            return lam, mu, err

        def inner_cond(t):
            lam, mu, err, loop, epsi = t
            return (err > 0.9 * epsi) & (loop < 100)

        def inner_body(t):
            lam, mu, err, loop, epsi = t
            lam, mu, err = newton_step(lam, mu, epsi)
            return (lam, mu, err, loop + 1, epsi)

        def outer_cond(s):
            lam, mu, err, epsi = s
            return epsi > tol

        def outer_body(s):
            lam, mu, err, epsi = s
            lam, mu, err, _, _ = jax.lax.while_loop(
                inner_cond, inner_body,
                (lam, mu, err, jnp.asarray(0, jnp.int32), epsi),
            )
            return (lam, mu, err, epsi * 0.1)

        lam, mu, err, _ = jax.lax.while_loop(
            outer_cond,
            outer_body,
            (lam0, mu0, jnp.asarray(1.0, dt), jnp.asarray(1.0, dt)),
        )
        x, y, z, lam = self._xyz_of_lambda(lam, sub)
        return x, lam, y, z

    # -------------------------------------------------------------- #

    def _update_impl(self, x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2,
                     fresh_asymptotes):
        sub = self._gensub(
            x, dfdx, gx, dgdx, xmin, xmax, L, U, xo1, xo2,
            fresh_asymptotes,
        )
        x_new, lam, y, z = self._solve_dip(sub)
        return x_new, sub[0], sub[1], lam, y, z

    # -------------------------------------------------------------- #

    def kkt_residual(self, x, dfdx, gx, dgdx, xmin, xmax):
        """KKTresidual (MMA.cc:428-496): (norm2, normInf) of the first-order
        conditions using the multipliers of the last solved subproblem."""
        lam = self.lam

        @jax.jit
        def _kkt(x, dfdx, dgdx, xmin, xmax, lam, y, z, gxv):
            ri = dfdx + jnp.tensordot(lam, dgdx, axes=1)
            mu_min = jnp.where((x < xmin + 1e-5) & (ri > 0.0), ri, 0.0)
            mu_max = jnp.where((x > xmax - 1e-5) & (ri < 0.0), -ri, 0.0)
            ri = ri - mu_min + mu_max
            r1 = mu_min * (x - xmin)
            r2 = mu_max * (xmax - x)
            n2 = (
                self._sum(ri**2)
                + self._sum(r1**2)
                + self._sum(r2**2)
            )
            ninf = jnp.maximum(
                self._maxr(jnp.abs(ri)),
                jnp.maximum(
                    self._maxr(jnp.abs(r1)), self._maxr(jnp.abs(r2))
                ),
            )
            rlam = jnp.sum(lam * (self.a * z + y - gxv))
            n2 = jnp.sqrt(n2 + rlam**2)
            ninf = jnp.maximum(ninf, jnp.abs(rlam))
            return n2, ninf

        n2, ninf = _kkt(
            x, dfdx, dgdx, xmin, xmax, lam, self.y, self.z, gx
        )
        return float(n2), float(ninf)
