"""The GPU precision policy's solver contract against the NumPy oracle.

Under utils/device.py's GPU policy (float32 fields, f64 true-residual
refinement) every solve must meet the reference's contract
||b - A x|| <= 1e-10 ||b|| on an f64 residual (src/main.cpp:26-27,
src/conjugate_gradient.cpp:45). The residual here is computed by the
per-site NumPy oracle of tests/reference_impl.py from exp(i theta) in f64
-- independent of the JAX stencil, the solver's own flag and its f64
operator.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from schwingermodel_tpu.config import CGParams, HMCParams, LatticeParams
from schwingermodel_tpu.models.schwinger import SchwingerModel
from schwingermodel_tpu.ops import eo
from schwingermodel_tpu.utils.device import device_policy
from tests.reference_impl import links_ref, normal_ref, schur_normal_ref

TOL = 1e-10


def _gpu_model(Nx, Nt, m0, even_odd):
    p = device_policy("gpu")
    return SchwingerModel(
        lattice=LatticeParams(Nx=Nx, Nt=Nt, real_dtype=p.real_dtype),
        hmc=HMCParams(beta=2.0, m0=m0, even_odd=even_odd,
                      cg=CGParams(tol=TOL, max_iter=10000, refine=p.refine,
                                  refine_impl=p.refine_impl)))


@pytest.mark.parametrize("even_odd", [True, False], ids=["eo", "fullD"])
@pytest.mark.parametrize("m0", [0.2, -0.1])
@pytest.mark.parametrize("Nx,Nt", [(8, 8), (6, 10), (16, 8)])
def test_refined_solve_meets_contract_vs_oracle(rng, Nx, Nt, m0, even_odd):
    model = _gpu_model(Nx, Nt, m0, even_odd)
    theta = jnp.asarray(rng.uniform(-np.pi, np.pi, (2, Nx, Nt)),
                        dtype=jnp.float32)
    nt_b = Nt // 2 if even_odd else Nt
    b = jnp.asarray(rng.standard_normal((2, Nx, nt_b))
                    + 1j * rng.standard_normal((2, Nx, nt_b)),
                    dtype=jnp.complex64)
    U = links_ref(theta)

    if even_odd:
        res = model._solve_eo(theta, model.eo_ops(theta), b)
        zeros = jnp.zeros_like(res.x)
        x = np.asarray(eo.unpack(model.geom, res.x, zeros))
        b_full = np.asarray(eo.unpack(model.geom, b.astype(jnp.complex128),
                                      zeros))
        r = b_full - schur_normal_ref(U, x, m0)
    else:
        res = model.solve_normal(theta, b)
        b_full = np.asarray(b, dtype=np.complex128)
        r = b_full - normal_ref(U, np.asarray(res.x), m0)

    assert res.x.dtype == jnp.complex128
    assert bool(res.converged)
    rel = np.linalg.norm(r) / np.linalg.norm(b_full)
    assert rel <= TOL, rel
