"""The one place that decides which fine-level operator runs where.

On a GPU the fine-level matvec of float32 solves is the fused Pallas
kernel (`ops.hex_triton`, Triton route); on the CPU, and for float64
configurations, it is the XLA gather form (`ops.hex_operator`).  Any
other platform is an error: there is no silent fallback.
"""

from __future__ import annotations

import jax

# -operator_impl: "auto" (the platform's form) or "xla" (the gather form
# everywhere, the A/B override)
IMPLS = ("auto", "xla")


def platform_operator(platform: str) -> str:
    """Operator form for a platform: "triton" on gpu, "xla" on cpu."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no fine-level operator for platform {platform!r}")


def resolve_operator(impl: str, dtype: str, platform: str | None = None):
    """Resolved operator form, "triton" or "xla", for a configuration.

    impl: "auto" or "xla"; dtype: the field dtype name.  The kernel
    computes in float32, so float64 configurations get the XLA form.
    """
    if impl not in IMPLS:
        raise ValueError(f"-operator_impl must be one of {IMPLS}, got {impl}")
    if impl == "xla" or dtype != "float32":
        return "xla"
    return platform_operator(platform or jax.devices()[0].platform)


def make_fine_apply(impl: str, KE):
    """``apply(u, scale)`` for the resolved form, or None for the XLA
    gather form (the multigrid's own default)."""
    if impl == "xla":
        return None
    from topopt_in_petsc_tpu.ops.hex_triton import make_triton_hex_apply

    return make_triton_hex_apply(KE)
