"""Wall-clock timing helpers.

The reference instruments with manual MPI_Wtime pairs around each outer
iteration (main.cc:59, 105) and each linear solve
(LinearElasticity.cc:187, 219).  These helpers are the JAX equivalent,
with `jax.block_until_ready` to close the async-dispatch gap.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import jax


class Timer:
    """Accumulating named timer."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def section(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(
                f"{name}: total {tot:.3f} s, calls {n}, "
                f"avg {tot / n * 1e3:.2f} ms"
            )
        return "\n".join(lines)


@contextmanager
def timed(label: str, result=None):
    t0 = time.perf_counter()
    yield
    if result is not None:
        jax.block_until_ready(result)
    print(f"{label}: {time.perf_counter() - t0:.4f} s")
