"""The golden-trajectory regression gate itself must work.

tools/compare_history.py is the automated gate run by chip_smoke.py and
by `make golden-gate` (docs/GOLDEN_RUN.md):
exit 0 when the fx trajectory matches the committed golden baseline
within rtol, non-zero on a breach.  These tests prove both sides of the
gate fire, so a trajectory regression cannot pass silently.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "docs" / "golden_history_65x33x33.npz"


def _run_gate(a, b, rtol=None):
    cmd = [sys.executable, str(REPO / "tools" / "compare_history.py"),
           str(a), str(b)]
    if rtol is not None:
        cmd.append(str(rtol))
    return subprocess.run(cmd, capture_output=True, text=True)


def test_gate_passes_on_identical(tmp_path):
    r = _run_gate(GOLDEN, GOLDEN)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS" in r.stdout


def test_gate_fails_on_fx_regression(tmp_path):
    d = dict(np.load(GOLDEN))
    d["fx"] = d["fx"] * 1.01  # 1% objective drift > 1e-3 gate
    bad = tmp_path / "bad.npz"
    np.savez(bad, **d)
    r = _run_gate(GOLDEN, bad)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "FAIL" in r.stdout


def test_gate_tolerates_short_prefix(tmp_path):
    # a truncated rerun (fewer iterations) gates only the common prefix
    d = dict(np.load(GOLDEN))
    short = {k: v[:10] for k, v in d.items()}
    p = tmp_path / "short.npz"
    np.savez(p, **short)
    r = _run_gate(GOLDEN, p)
    assert r.returncode == 0, r.stdout + r.stderr
