"""Declarative run configuration.

Replaces the reference's two-tier config (compile-time lattice dims via CMake
`configure_file`, CMakeLists.txt:17-20 / include/config.h.in, plus interactive
stdin prompts bcast to all ranks, src/main.cpp:30-69). Here everything is a
runtime dataclass; lattice dims are ordinary array shapes, no rebuild per size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp


def _complex_of(real_dtype) -> jnp.dtype:
    return jnp.dtype(jnp.complex128) if jnp.dtype(real_dtype) == jnp.float64 else jnp.dtype(jnp.complex64)


@dataclasses.dataclass(frozen=True)
class LatticeParams:
    """Lattice geometry and precision policy.

    Axis convention follows the reference (src/dirac_operator.cpp:5-21):
    site n = (x, t); mu=0 is the *time* direction (t -> t+1), mu=1 is the
    *space* direction (x -> x+1). Fields are arrays [..., 2, Nx, Nt] with the
    direction/spin axis third-from-last, x second-from-last, t last.
    """

    Nx: int = 64
    Nt: int = 64
    # Real dtype of angles/momenta; complex fields use the paired complex dtype.
    # float64 needs jax.config.update("jax_enable_x64", True) (the CPU
    # policy); float32 is the GPU working precision (utils/device.py).
    real_dtype: str = "float32"

    @property
    def volume(self) -> int:
        return self.Nx * self.Nt

    @property
    def rdtype(self):
        return jnp.dtype(self.real_dtype)

    @property
    def cdtype(self):
        return _complex_of(self.rdtype)

    @property
    def kappa(self) -> float:
        raise AttributeError("kappa depends on m0; use HMCParams.kappa")


@dataclasses.dataclass(frozen=True)
class CGParams:
    """Conjugate-gradient solver knobs.

    Reference defaults: max_iter=10000, relative tol=1e-10
    (src/main.cpp:26-27, src/conjugate_gradient.cpp:45 uses
    ||r|| < tol * ||phi||).
    """

    tol: float = 1e-10
    max_iter: int = 10000
    # Mixed-precision iterative refinement (solvers/refine.py): on f32 runs,
    # accumulate the solution and the true residual in f64 while the inner
    # CG sweeps run in f32, so `tol` is met in the reference's own f64 sense
    # (src/main.cpp:26-27). Ignored when the working dtype is already
    # float64. The x64 impl needs jax_enable_x64 (the CLI turns it on).
    refine: bool = False
    # Refinement arithmetic for the true residual: "x64" uses native f64
    # (needs jax_enable_x64), "dfloat" uses double-float f32-pair
    # arithmetic (solvers/dfloat.py; requires a backend that preserves
    # error-free transforms, dfloat.eft_selfcheck). "auto" = x64.
    refine_impl: str = "auto"
    # Relative tolerance of each f32 inner solve; the refinement loop
    # contracts the true residual by ~max(inner_tol, kappa*eps_f32) per pass.
    inner_tol: float = 1e-5
    # Cap on refinement passes (2-4 typical; stagnation exits early).
    max_outer: int = 8
    # MD force-solve tolerance. The ACTION solves entering the Metropolis
    # dH always run at `tol` (the reference's 1e-10 contract,
    # src/main.cpp:26-27), but the FORCE solves only steer the integrator:
    # their error perturbs the trajectory like any integrator error and is
    # corrected exactly by the accept/reject, with the reversibility
    # residue (forecasted x0 makes forces weakly direction-dependent)
    # bounded by this tolerance -- far below the dH resolution. Standard
    # practice in production lattice HMC (e.g. MILC/QUDA split residuals).
    # None = auto: 1e-8 under cg.refine (two decades looser than the
    # 1e-10 action solves; <exp(-dH)>=1 and crossvalidation gates cover
    # it), else `tol` (no split -- the loose contract and f64 runs match
    # the reference exactly).
    force_tol: Optional[float] = None

    # f64-grade CG fallback on refinement stagnation: when the f32 inner
    # solves hit their conditioning floor (kappa(A)*eps_f32 >~ 1 on the
    # near-critical exceptional configurations), continue the solve as a
    # plain f64 (x64 impl) or double-float (dfloat impl) CG recursion from
    # the refined state, so the shipped tol converges wherever the
    # reference's own f64 CG does (src/conjugate_gradient.cpp:4-66). Zero
    # cost when refinement converges (the fallback loops never execute).
    fallback: bool = True

    def resolved_force_tol(self) -> float:
        if self.force_tol is not None:
            return self.force_tol
        return max(self.tol, 1e-8) if self.refine else self.tol


@dataclasses.dataclass(frozen=True)
class HMCParams:
    """Physics + molecular-dynamics parameters (reference src/main.cpp:30-58)."""

    beta: float = 4.0
    m0: float = 0.2
    md_steps: int = 10          # MD_steps (leapfrog structure hmc.cpp:63-103)
    trajectory_length: float = 0.1
    cg: CGParams = dataclasses.field(default_factory=CGParams)
    # Pure-gauge (quenched) mode: no pseudofermions, no CG. Not available in
    # the reference; enables the exact 2D U(1) plaquette check
    # <P> = I1(beta)/I0(beta) as a physics gate.
    quenched: bool = False
    # Skip the redundant CG solve in H_old: phi = D chi implies
    # phi^+ (DD^+)^-1 phi == |chi|^2 exactly, so the old Hamiltonian's fermion
    # action needs no solver (the reference recomputes it with a full CG,
    # hmc.cpp:105-133 called twice at hmc.cpp:162).
    exact_initial_fermion_action: bool = True
    # Even-odd (Schur-complement) preconditioned pseudofermions (ops/eo.py):
    # exactly the same gauge-field distribution as the reference's full-D
    # pseudofermions (det D = const * det Dhat for Wilson fermions), at about
    # half the CG iterations on half-size fields. Requires even Nx, Nt.
    # The reference has no preconditioning (src/conjugate_gradient.cpp).
    even_odd: bool = False
    # Hasenbusch mass preconditioning (two pseudofermion fields; new
    # capability -- the reference runs single-pseudofermion HMC,
    # src/hmc.cpp:159-160, whose acceptance collapses with volume near the
    # critical mass, README.md:94). The determinant is split with a heavier
    # auxiliary Wilson mass m1 = m0 + hasenbusch_dm:
    #     det(D0 D0^+) = det(D1 D1^+) . det(D1^{-1} D0 D0^+ D1^{-+})
    # (constant factors cancel in HMC), one pseudofermion per factor:
    #     S1 = phi1^+ (D1 D1^+)^{-1} phi1          (heavy -- cheap solves)
    #     S2 = (D1 phi2)^+ (D0 D0^+)^{-1} (D1 phi2)  (ratio -- light solves
    #                                                against a smoothed rhs)
    # The ratio term's force fluctuations are suppressed by ~the mass-gap
    # ratio, restoring acceptance at the critical mass (Hasenbusch, Phys.
    # Lett. B 519 (2001) 177). Exact: heat baths are phi1 = D1 chi1 and
    # phi2 = D1^{-1} D0 chi2 (one heavy solve), so the sampled distribution
    # is identical to single-pseudofermion HMC. None/0 = off. Typical
    # dm ~ 0.2-0.5 near m_crit.
    hasenbusch_dm: Optional[float] = None
    # Chronological forecasting: start each force CG from the previous MD
    # step's solution (and the final Hamiltonian solve from the last force
    # solve), instead of the reference's restart-from-b
    # (src/conjugate_gradient.cpp:16). Saves ~1/3 of CG iterations; exact
    # detailed-balance diagnostics (<exp(-dH)> = 1) are unaffected at the
    # solver tolerance (tested).
    cg_forecast: bool = True
    # MD integrator: "leapfrog" reproduces the reference's position-first
    # scheme (src/hmc.cpp:63-103, MD_steps-1 force evaluations); "omelyan"
    # is the 2nd-order minimum-norm (2MN) scheme of Omelyan/Mryglod/Folk
    # (Comput. Phys. Commun. 151 (2003) 272), 2*md_steps force evaluations
    # per trajectory but a ~10x smaller dH error constant -- at equal force
    # budget (half the md_steps) it reaches higher acceptance than
    # leapfrog. New capability; the reference has leapfrog only.
    integrator: str = "leapfrog"

    @property
    def kappa(self) -> float:
        return 1.0 / (2.0 * (self.m0 + 2.0))

    @property
    def step_size(self) -> float:
        return self.trajectory_length / float(self.md_steps)


@dataclasses.dataclass(frozen=True)
class RunParams:
    """Outer Monte-Carlo loop parameters (reference src/main.cpp:49-58)."""

    n_therm: int = 100
    n_meas: int = 100
    n_steps: int = 0            # decorrelation sweeps between measurements
    save_conf: bool = False
    n_chains: int = 1           # vmapped independent chains (new capability)
    seed: int = 0
    out_dir: str = "."
    # Optional mesh shape for device sharding; None = single device.
    # (ranks_x, ranks_t) = 2D lattice domain decomposition;
    # (ranks_chain, ranks_x, ranks_t) additionally shards independent chains
    # over a leading data-parallel 'chain' mesh axis.
    mesh_shape: Optional[Tuple[int, ...]] = None
    # Step-size autotuning (new capability; the reference asks the user to
    # hand-tune MD_steps/tau for 0.6-0.8 acceptance, README.md:87-94):
    # dual-averaging warmup on pooled acceptance, then md_steps is re-fixed
    # at trajectory_length/eps for the measurement phase (hmc/autotune.py).
    autotune: bool = False
    tune_target: float = 0.7    # middle of the reference's acceptance band
    n_tune: int = 100           # warmup trajectories used for tuning
