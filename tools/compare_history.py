"""Compare two optimization-history .npz files (CLI `history.npz` or
docs/golden_history_*.npz): per-field trajectory deltas + a pass/fail
gate for regression checks against the golden run (docs/GOLDEN_RUN.md).

Usage: python tools/compare_history.py <a.npz> <b.npz> [rtol]
Exit 0 if fx agrees within rtol (default 1e-3) at every common
iteration, 1 otherwise.
"""

import sys

import numpy as np


def max_rel_diff(a, b) -> float:
    """Largest |a - b| / max(|a|, 1e-12) over the common prefix."""
    n = min(len(a), len(b))
    if n == 0:
        return float("inf")
    va, vb = np.asarray(a, float)[:n], np.asarray(b, float)[:n]
    return float((np.abs(va - vb) / np.maximum(np.abs(va), 1e-12)).max())


def main() -> int:
    a_path, b_path = sys.argv[1], sys.argv[2]
    rtol = float(sys.argv[3]) if len(sys.argv) > 3 else 1e-3
    a = np.load(a_path)
    b = np.load(b_path)
    common = sorted(set(a.files) & set(b.files) - {"stalled"})
    n = min(len(a["fx"]), len(b["fx"]))
    print(f"{a_path}: {len(a['fx'])} iters, {b_path}: {len(b['fx'])} "
          f"iters, comparing first {n}")
    ok = True
    for k in common:
        va, vb = np.asarray(a[k], float)[:n], np.asarray(b[k], float)[:n]
        if va.size != vb.size or va.size == 0:
            continue
        denom = np.maximum(np.abs(va), 1e-12)
        rel = np.abs(va - vb) / denom
        i = int(np.argmax(rel))
        print(f"  {k:8s} max rel diff {rel.max():.3e} at iter {i + 1} "
              f"({va[i]:.6g} vs {vb[i]:.6g})")
        if k == "fx" and rel.max() > rtol:
            ok = False
    print("PASS" if ok else f"FAIL (fx rel diff > {rtol})")
    return 0 if ok else 1


if __name__ == "__main__":
    main_rc = main()
    sys.exit(main_rc)
