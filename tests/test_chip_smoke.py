"""chip_smoke.py: refuses to run without a GPU or without the repository,
and its comparison helpers enforce the stated tolerances."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke as cs  # noqa: E402


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(r):
    return not any(line.startswith("{") for line in r.stdout.splitlines())


def test_exits_nonzero_without_gpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _no_result(r)


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert _no_result(r)


def test_rejects_unknown_arguments():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO, "--bogus")
    assert r.returncode == 2 and _no_result(r)


def test_rel_errors():
    ref = np.array([1.0, -2.0, 4.0])
    l2, mx = cs.rel_errors(ref * (1 + 1e-7), ref)
    assert l2 == pytest.approx(1e-7, rel=1e-3)
    assert mx == pytest.approx(1e-7, rel=1e-3)


def test_check_matvec_tolerances():
    cs.check_matvec("ok", 1.9e-6, 9e-6)
    with pytest.raises(cs.PhaseFailed):
        cs.check_matvec("l2", 3e-6, 1e-7)
    with pytest.raises(cs.PhaseFailed):
        cs.check_matvec("max", 1e-7, 2e-5)
    # TF32 products (~1e-3 relative) must fail
    with pytest.raises(cs.PhaseFailed):
        cs.check_matvec("tf32", 1e-3, 1e-3)


def test_check_agree_and_relres():
    a = [26.0, 18.0, 11.5]
    cs.check_agree("same", a, list(a), 1e-4)
    cs.check_agree("prefix", a, a[:2], 1e-4)
    with pytest.raises(cs.PhaseFailed):
        cs.check_agree("drift", a, [26.0, 18.01, 11.5], 1e-4)
    with pytest.raises(cs.PhaseFailed):
        cs.check_agree("empty", a, [], 1e-4)
    cs.check_relres("conv", [9e-6, 1e-6])
    with pytest.raises(cs.PhaseFailed):
        cs.check_relres("stalled", [9e-6, 2e-5])


def test_real_size_phase_on_a_small_grid(tmp_path, capsys):
    # the phase's own logic (float32 runs, float64 split/fused/resume
    # agreement) at 17^3 nodes on the CPU
    cs.phase_real_size(str(tmp_path), n=17, nlvls=2)
    out = capsys.readouterr().out
    assert "float64 resumed vs straight-through iteration 4" in out
    assert "FAIL" not in out


def test_four_phase_on_virtual_devices(tmp_path, capsys):
    cs.phase_four(str(tmp_path), n=17, nlvls=2, mesh="4,1,1")
    out = capsys.readouterr().out
    assert "4 cards vs 1 card" in out and "FAIL" not in out


def test_golden_is_float64_and_float32_stays_within_the_limit():
    # the golden is a float64 trajectory; float32 strays from it by
    # ~1.3e-3 over 20 iterations, inside GOLDEN_RTOL, and the old
    # lower-precision recording (4.1e-3 off) would fail the gate
    g = np.load(os.path.join(REPO, "docs", "golden_history_65x33x33.npz"))
    assert g["fx"][0] == pytest.approx(26.091795, abs=1e-6)
    assert 1.3e-3 < cs.GOLDEN_RTOL < 4e-3


def test_result_line_format():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 4)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4},
    }
