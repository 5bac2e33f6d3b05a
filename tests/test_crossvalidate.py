"""Statistical 2-sigma gate against the compiled C++ reference.

The goldens (tests/golden/refphys.json) were produced by the actual
reference binary (tools/refcheck/run_goldens.py; built by
build_reference.sh with the MPI single-rank stub): 500 therm + 2000
measurements per point at the reference's own solver contract (f64, CG tol
1e-10, src/main.cpp:26-27). This test re-runs a subset through the
framework with identical MD parameters and the SAME full-D pseudofermion
action and gates:

  - <plaquette> within 2 sigma (combined jackknife errors) -- the physics
  - acceptance rate within 3 sigma (binomial) -- the algorithm; comparable
    only at equal action, which is why even_odd is off here

The full 14-point table (both lattices, beta = 1..6, near-critical mass)
is committed as docs/CROSSCHECK.md + tests/golden/crosscheck_f64_fulld.json
and regenerated with:  python -m schwingermodel_tpu.tools.crossvalidate
"""

import argparse
import json
import os

import pytest

from schwingermodel_tpu.tools import crossvalidate as cv

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "refphys.json")


def _args(**kw):
    defaults = dict(
        dtype="float64", refine=False, even_odd=False, chains=1, seed=11,
        nmeas=None, n_sigma=2.0, n_sigma_acc=3.0,
    )
    defaults.update(kw)
    return argparse.Namespace(**defaults)


def _point(Nx, beta, m0):
    pts = [r for r in json.load(open(GOLDEN))
           if r["Nx"] == Nx and r["beta"] == beta and r["m0"] == m0]
    assert len(pts) == 1, (Nx, beta, m0)
    return pts[0]


@pytest.mark.slow
@pytest.mark.parametrize("beta,m0", [(2.0, 0.2), (2.0, -0.19)])
def test_8x8_within_2sigma_of_cpp(beta, m0):
    """8x8 at beta=2: the standard mass and the near-critical one
    (m_crit(beta=2) = -0.1968(9), reference README.md:100-111)."""
    ref = _point(8, beta, m0)
    r = cv.compare_point(ref, _args())
    assert r["pass_Ep"], (
        f"plaquette off by {r['n_sigma_Ep']:.2f} sigma: "
        f"ref {r['ref_Ep']:.6f}({r['ref_dEp']:.6f}) vs {r['Ep']:.6f}({r['dEp']:.6f})")
    assert r["pass_acc"], (
        f"acceptance off by {r['n_sigma_acc']:.2f} sigma: "
        f"ref {r['ref_acceptance']:.3f} vs {r['acceptance']:.3f}")


@pytest.mark.slow
def test_committed_fulld_table_passes():
    """The committed full-table artifact must be green end to end (both
    gates, every point). Regenerate with tools.crossvalidate if physics
    changes."""
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "crosscheck_f64_fulld.json")
    rows = json.load(open(path))
    assert len(rows) >= 14
    bad = [r for r in rows if not (r["pass_Ep"] and r["pass_acc"])]
    assert not bad, bad


def test_committed_f32_table_passes():
    """The f32 + refinement (shipped numerics) 14-point table must be green
    (docs/CROSSCHECK_f32.md; full-D action so both gates apply)."""
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "crosscheck_f32.json")
    rows = json.load(open(path))
    assert len(rows) >= 14
    bad = [r for r in rows if not (r["pass_Ep"] and r["pass_acc"])]
    assert not bad, bad
