"""The one platform decision (ops/select.py) and the compile-cache rule
(utils/compile_cache.py)."""

import os
import subprocess
import sys

import pytest

from topopt_in_petsc_tpu.ops.select import (
    make_fine_apply,
    platform_operator,
    resolve_operator,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,expected", [("gpu", "triton"), ("cpu", "xla")]
)
def test_platform_operator(platform, expected):
    assert platform_operator(platform) == expected


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no fine-level operator"):
        platform_operator(platform)


@pytest.mark.parametrize(
    "impl,dtype,platform,expected",
    [
        ("auto", "float32", "gpu", "triton"),
        ("auto", "float64", "gpu", "xla"),
        ("auto", "float32", "cpu", "xla"),
        ("xla", "float32", "gpu", "xla"),
        ("xla", "float64", "cpu", "xla"),
    ],
)
def test_resolve_operator(impl, dtype, platform, expected):
    assert resolve_operator(impl, dtype, platform) == expected


@pytest.mark.parametrize("impl", ["triton", "pallas", "blocked", ""])
def test_resolve_operator_rejects(impl):
    # the kernel is reached only through "auto" on a GPU
    with pytest.raises(ValueError, match="operator_impl"):
        resolve_operator(impl, "float32", "gpu")


def test_auto_on_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="no fine-level operator"):
        resolve_operator("auto", "float32", "rocm")


def test_make_fine_apply():
    from topopt_in_petsc_tpu.models.elements import hex8_stiffness

    KE = hex8_stiffness(0.1, 0.1, 0.1, 0.3)
    assert make_fine_apply("xla", KE) is None
    assert callable(make_fine_apply("triton", KE))


def test_banner_names_the_operator():
    from topopt_in_petsc_tpu.config import TopOptConfig

    assert "# -operator_impl: xla" in TopOptConfig().banner()


def _cache_dir(env):
    code = (
        "import jax; from topopt_in_petsc_tpu.utils.compile_cache import "
        "enable_compile_cache as e; p = e(); "
        "print(p); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, check=True,
    ).stdout.split("\n")
    return out[0], out[1]


def test_compile_cache_default_is_the_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    path, configured = _cache_dir(env)
    assert path == configured == os.path.join(REPO, ".jax_cache")


def test_compile_cache_follows_the_environment(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"),
               PYTHONPATH=REPO)
    path, configured = _cache_dir(env)
    assert path == configured == str(tmp_path / "c")
