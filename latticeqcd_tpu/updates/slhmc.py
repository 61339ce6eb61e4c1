"""Self-learning updaters: SLHMC and SLMC.

The reference advertises self-learning HMC as a capability
(/root/reference/README.md:113) and its wizard offers it
(/root/reference/src/system/wizard.jl:340-349), but the post-1.0
update factory never wires it (SURVEY.md 2.2 "SLHMC updater (dead)"),
so `update_method = "SLHMC"` errors there.  This module provides a
*working* implementation of both algorithms, with the
semantics of the reference's archived versions:

* **SLHMC** (/root/reference/src/updates/SLHMC.jl:51-98): molecular
  dynamics is driven by a cheap *effective* gauge action
  S_eff(U) = sum_i beta_eff_i * l_i(U) over a loop basis, while the
  Metropolis test uses the TRUE action (gauge + pseudofermion).  The
  MD trajectory is therefore purely gluonic — no CG solves inside the
  integrator loop (no while_loop nested in the MD loop; solver calls
  happen only at the trajectory endpoints).  Exactness: the leapfrog under S_eff is
  reversible and measure-preserving, so accepting with
  exp(H_true(old) - H_true(new)) satisfies detailed balance with
  respect to exp(-S_true) for ANY S_eff; the learning only affects
  the acceptance rate, never the sampled distribution.

* **SLMC** (legacy driver /root/reference/src/system/mainrun.jl:541-548):
  the proposal is a sweep of exact heatbath updates under S_eff; since
  the heatbath kernel is detailed-balanced with respect to exp(-S_eff),
  the reweighting Metropolis test
      accept with exp[(S_true - S_eff)(old) - (S_true - S_eff)(new)]
  makes the composite chain exact for exp(-S_true) (that is the
  `Sold = Sg + Sf - Sgeff` bookkeeping at mainrun.jl:544-546).

* **Learning** (mainrun.jl:590-604): after each trajectory the pair
  (loop values l_i(U), S_true(U)) is recorded and the effective
  couplings are refit by least squares
      S_true(U) ~= const + sum_i beta_eff_i l_i(U);
  the fit is applied from trajectory `firstlearn` on (the reference's
  `IsSucs && itrj >= firstlearn` gate, mainrun.jl:601-603).

The loop values l_i use the same normalization as the gauge action
(adjoint-closed loop set at coupling 1, S = -Re tr/NC), so beta_eff is
directly comparable to the physical beta.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from latticeqcd_tpu.md import integrators
from latticeqcd_tpu.ops import gauge_action as ga
from latticeqcd_tpu.ops import sun
from latticeqcd_tpu.ops.wilsonline import Wilsonline, make_loops_fromname
from latticeqcd_tpu.updates.heatbath import Heatbath


# ---------------------------------------------------------------------------
# Effective-action loop basis
# ---------------------------------------------------------------------------


class EffectiveGaugeBasis:
    """A basis of unit-coupling gauge actions {l_i}; S_eff = coeffs . l.

    couplinglist uses the reference's loop names (kindsof_loops,
    parameter_structs.jl:232-240); coupling_loops may supply raw
    symbolic paths [[(mu, len), ...], ...] instead (the
    Print_SLMC_parameters.coupling_loops field)."""

    def __init__(self, nc: int, couplinglist: Sequence[str] = ("plaquette",),
                 lattice=None, coupling_loops=None):
        self.nc = nc
        loopsets = []
        self.names = []
        if coupling_loops is not None:
            for k, path in enumerate(coupling_loops):
                loopsets.append([Wilsonline([tuple(s) for s in path])])
                self.names.append(f"loops{k}")
        else:
            for name in couplinglist:
                loopsets.append(make_loops_fromname(name, 4, lattice=lattice))
                self.names.append(name)
        # unit coupling: the same beta/2 + adjoint-closure convention as
        # the physical action, so coeff == beta for a plaquette basis.
        self.unit_actions = tuple(
            ga.general_gauge_action(nc, [1.0], [ls]) for ls in loopsets
        )

    @property
    def n(self) -> int:
        return len(self.unit_actions)

    def loop_values(self, u: jnp.ndarray) -> jnp.ndarray:
        """l_i(U) = S of the unit action i (shape (n,))."""
        return jnp.stack([ga.action_value(a, u) for a in self.unit_actions])

    def action_value(self, u: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
        return jnp.sum(coeffs * self.loop_values(u))

    def force(self, u: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
        """Momentum time-derivative for S_eff; coeffs is traced, so the
        jitted MD program is reused across learning updates."""
        out = 0.0
        for i, a in enumerate(self.unit_actions):
            out = out + coeffs[i] * ga.force(a, u)
        return out


class SLMCLearner:
    """Least-squares fit S_true ~= const + beta_eff . l over the chain
    history (the SLMC_data/show_effbeta bookkeeping, mainrun.jl:590-604)."""

    # the refit is O(n * nbasis^2) per trajectory; an unbounded history
    # would make a long chain's host cost grow quadratically, and old
    # equilibration-era samples only dilute the fit anyway
    MAX_HISTORY = 8192

    def __init__(self, nbasis: int):
        self.nbasis = nbasis
        self.feats: list = []
        self.targets: list = []

    def record(self, feats, target) -> None:
        self.feats.append(np.asarray(feats, dtype=np.float64))
        self.targets.append(float(target))
        if len(self.targets) > self.MAX_HISTORY:
            del self.feats[0]
            del self.targets[0]

    def fit(self) -> Optional[np.ndarray]:
        """Returns beta_eff (nbasis,) or None if underdetermined/sick
        (the reference's IsSucs gate, mainrun.jl:601)."""
        if len(self.targets) < self.nbasis + 1:
            return None
        a = np.stack(self.feats)
        # with an intercept column, the slope fit is only determined if
        # the centered features span the basis
        if np.linalg.matrix_rank(a - a.mean(axis=0), tol=1e-10) < self.nbasis:
            return None
        a = np.concatenate([np.ones((a.shape[0], 1)), a], axis=1)
        y = np.asarray(self.targets)
        sol, *_ = np.linalg.lstsq(a, y, rcond=None)
        betas = sol[1:]
        if not np.all(np.isfinite(betas)):
            return None
        return betas


# ---------------------------------------------------------------------------
# SLHMC
# ---------------------------------------------------------------------------


class SLHMC:
    """Self-learning HMC: gluonic MD under a learned effective action,
    Metropolis against the exact action (SLHMC.jl:51-98 semantics).

    `action` is the TRUE gauge action; `fermi_action` (optional) the
    TRUE pseudofermion action.  beta_eff: initial effective couplings
    (scalar broadcasts onto the first basis element)."""

    def __init__(self, action: ga.GaugeAction, dtau: float, md_steps: int,
                 fermi_action: Optional[Any] = None, smearing: Optional[Any] = None,
                 beta_eff=None, firstlearn: int = 10,
                 couplinglist: Sequence[str] = ("plaquette",),
                 coupling_loops=None, lattice=None,
                 scheme: str = "QPQ", omelyan_lambda: float | None = None,
                 learn: bool = True):
        self.action = action
        self.dtau = float(dtau)
        self.md_steps = int(md_steps)
        self.fermi_action = fermi_action
        self.smearing = smearing
        self.firstlearn = int(firstlearn)
        self.scheme = scheme
        self.omelyan_lambda = (
            integrators.OMELYAN_2MN_LAMBDA if omelyan_lambda is None
            else float(omelyan_lambda)
        )
        self.learn = learn
        self.basis = EffectiveGaugeBasis(
            action.nc, couplinglist, lattice=lattice, coupling_loops=coupling_loops
        )
        init = np.zeros(self.basis.n)
        if beta_eff is None:
            init[0] = _leading_coupling(action)
        else:
            be = np.atleast_1d(np.asarray(beta_eff, dtype=np.float64))
            init[: be.size] = be
        self.beta_eff = init
        self.learner = SLMCLearner(self.basis.n)
        self.itrj = 0

    @property
    def quench(self) -> bool:
        return self.fermi_action is None

    # -- jitted pieces (self is a static arg hashed by identity, so the
    #    compiled programs persist across beta_eff updates: coeffs is traced)
    @partial(jax.jit, static_argnums=0)
    def _draw_momentum(self, u, key):
        return sun.random_hermitian_momentum(key, u.shape[:-2], self.action.nc, dtype=u.dtype)

    @partial(jax.jit, static_argnums=0)
    def _md(self, u, h, coeffs):
        force_gauge = lambda uu: self.basis.force(uu, coeffs)
        return integrators.run_md(u, h, force_gauge, self.dtau, self.md_steps,
                                  scheme=self.scheme,
                                  omelyan_lambda=self.omelyan_lambda)

    @partial(jax.jit, static_argnums=0)
    def _energy(self, u, h):
        return sun.kinetic_energy(h), ga.action_value(self.action, u)

    @partial(jax.jit, static_argnums=0)
    def _feats(self, u):
        return self.basis.loop_values(u)

    def _smear(self, u):
        return u if self.smearing is None else self.smearing.smear(u)

    # ------------------------------------------------------------------
    def step(self, u: jnp.ndarray, key: jnp.ndarray):
        """One trajectory: (U, key) -> (U', key', stats)."""
        u0 = u
        key, k_mom, k_ferm, k_acc = jax.random.split(key, 4)
        h = self._draw_momentum(u, k_mom)

        s_f_old = 0.0
        eta = None
        if not self.quench:
            s_f_old, eta = self.fermi_action.sample_pseudofermion(self._smear(u), k_ferm)
        sp_old, sg_old = self._energy(u, h)
        s_old = sp_old + sg_old + s_f_old

        rdtype = jnp.float64 if u.dtype == jnp.complex128 else jnp.float32
        coeffs = jnp.asarray(self.beta_eff, dtype=rdtype)
        u_new, h_new = self._md(u, h, coeffs)

        sp_new, sg_new = self._energy(u_new, h_new)
        s_f_new = 0.0
        if not self.quench:
            s_f_new = jnp.real(self.fermi_action.action(self._smear(u_new), eta))
        s_new = sp_new + sg_new + s_f_new

        d_h = s_new - s_old
        accept = bool(jnp.exp(-d_h) >= jax.random.uniform(k_acc, dtype=rdtype))
        u_out = u_new if accept else u0

        self.itrj += 1
        if self.learn:
            # record the PROPOSAL endpoint (fresh training data every
            # trajectory even when rejected — duplicate rows would make
            # the regression rank-deficient), plus the start point once
            if self.itrj == 1:
                self.learner.record(np.asarray(self._feats(u0)),
                                    float(sg_old + s_f_old))
            self.learner.record(np.asarray(self._feats(u_new)),
                                float(sg_new + s_f_new))
            if self.itrj >= self.firstlearn:
                betas = self.learner.fit()
                if betas is not None:
                    self.beta_eff = betas

        stats = {
            "accepted": accept,
            "dH": d_h,
            "sg_old": sg_old,
            "sg_new": sg_new,
            "sp_old": sp_old,
            "sp_new": sp_new,
            "sf_old": s_f_old,
            "sf_new": s_f_new,
            "plaq": ga.mean_plaquette(u_out),
            "beta_eff": tuple(float(b) for b in self.beta_eff),
        }
        return u_out, key, stats


# ---------------------------------------------------------------------------
# SLMC
# ---------------------------------------------------------------------------


class SLMC:
    """Self-learning Monte Carlo: heatbath proposals under the learned
    effective action + reweighting Metropolis against the true action
    (mainrun.jl:541-548).  `fermi_logdet`, when given, is a callable
    U -> S_f(U) providing the EXACT (integrated) fermion action — see
    `dense_logdet_fermi_action` for small lattices."""

    def __init__(self, action: ga.GaugeAction, beta_eff=None, firstlearn: int = 10,
                 couplinglist: Sequence[str] = ("plaquette",), coupling_loops=None,
                 lattice=None, fermi_logdet=None, nsweeps: int = 1,
                 iteration_max: int = 10 ** 5, learn: bool = True):
        self.action = action
        self.fermi_logdet = fermi_logdet
        self.nsweeps = int(nsweeps)
        self.firstlearn = int(firstlearn)
        self.learn = learn
        self.basis = EffectiveGaugeBasis(
            action.nc, couplinglist, lattice=lattice, coupling_loops=coupling_loops
        )
        init = np.zeros(self.basis.n)
        if beta_eff is None:
            init[0] = _leading_coupling(action)
        else:
            be = np.atleast_1d(np.asarray(beta_eff, dtype=np.float64))
            init[: be.size] = be
        self.beta_eff = init
        self.learner = SLMCLearner(self.basis.n)
        self.itrj = 0
        self.hb = Heatbath(action=self.basis.unit_actions[0],
                           basis=self.basis.unit_actions,
                           iteration_max=iteration_max)

    @partial(jax.jit, static_argnums=0)
    def _values(self, u, coeffs):
        return ga.action_value(self.action, u), self.basis.action_value(u, coeffs), \
            self.basis.loop_values(u)

    def step(self, u: jnp.ndarray, key: jnp.ndarray):
        rdtype = jnp.float64 if u.dtype == jnp.complex128 else jnp.float32
        coeffs = jnp.asarray(self.beta_eff, dtype=rdtype)
        key, k_acc = jax.random.split(key)

        sg_old, seff_old, _ = self._values(u, coeffs)
        sf_old = self.fermi_logdet(u) if self.fermi_logdet is not None else 0.0

        u_prop = u
        for _ in range(self.nsweeps):
            u_prop, key = self.hb.sweep_with_coeffs(u_prop, key, coeffs)
        sg_new, seff_new, feats_new = self._values(u_prop, coeffs)
        sf_new = self.fermi_logdet(u_prop) if self.fermi_logdet is not None else 0.0

        d_s = (sg_new + sf_new - seff_new) - (sg_old + sf_old - seff_old)
        accept = bool(jnp.exp(-d_s) >= jax.random.uniform(k_acc, dtype=rdtype))
        u_out = u_prop if accept else u

        self.itrj += 1
        if self.learn:
            if self.itrj == 1:
                self.learner.record(np.asarray(self._values(u, coeffs)[2]),
                                    float(sg_old + sf_old))
            self.learner.record(np.asarray(feats_new), float(sg_new + sf_new))
            if self.itrj >= self.firstlearn:
                betas = self.learner.fit()
                if betas is not None:
                    self.beta_eff = betas

        stats = {
            "accepted": accept,
            "dH": d_s,
            "plaq": ga.mean_plaquette(u_out),
            "beta_eff": tuple(float(b) for b in self.beta_eff),
        }
        return u_out, key, stats


# ---------------------------------------------------------------------------
# Exact fermion action for SLMC on small lattices
# ---------------------------------------------------------------------------


def dense_logdet_fermi_action(dirac, psi_shape, weight: float, dtype=jnp.complex128):
    """Return a callable U -> S_f(U) = -weight * log det(D^dag D),
    built densely by applying D to every basis vector (vmapped).

    weight: Nf/8 for staggered det(D)^{Nf/4} (det D real > 0 so
    det(D)^{Nf/4} = det(D^dag D)^{Nf/8}); 1 for 2-flavor Wilson
    (gamma5-hermiticity gives det(D)^2 = det(D^dag D)).  Intended for
    the small volumes where SLMC-style integrated-fermion updates are
    used (the reference's IntegratedHMC/SLMC legacy path,
    mainrun.jl:475-548)."""
    dim = int(np.prod(psi_shape))
    eye = jnp.eye(dim, dtype=dtype)

    @jax.jit
    def s_f(u):
        cols = jax.vmap(lambda v: dirac.apply(u, v.reshape(psi_shape)).reshape(dim))(eye)
        d_mat = jnp.transpose(cols)  # column j = D e_j
        # a dense (dim x dim) product: a real GEMM, at full precision
        gram = jnp.matmul(sun.dagger(d_mat), d_mat, precision=jax.lax.Precision.HIGHEST)
        _, logdet = jnp.linalg.slogdet(gram)
        return -weight * jnp.real(logdet)

    return s_f


def integrated_hmc(action: ga.GaugeAction, dtau: float, md_steps: int,
                   fermi_logdet=None, scheme: str = "QPQ",
                   omelyan_lambda: float | None = None) -> "SLHMC":
    """IntegratedHMC (legacy /root/reference/src/system/mainrun.jl:475-500):
    gauge-only MD, Metropolis on S_g + S_f with the EXACT (integrated)
    fermion action S_f = -log det — i.e. SLHMC with the effective action
    pinned to the gauge action and no learning, plus a deterministic
    fermion term at the endpoints. fermi_logdet: callable U -> S_f(U)
    (dense_logdet_fermi_action for small lattices); None gives the
    quenched special case."""
    up = SLHMC(action, dtau, md_steps, scheme=scheme,
               omelyan_lambda=omelyan_lambda, learn=False)
    if fermi_logdet is not None:
        up.fermi_action = _LogdetAsFermiAction(fermi_logdet)
    return up


def integrated_hb(action: ga.GaugeAction, fermi_logdet=None,
                  beta_eff=None, nsweeps: int = 1,
                  iteration_max: int = 10 ** 5) -> "SLMC":
    """IntegratedHB (legacy mainrun.jl:550-577): heatbath proposal under
    an effective gauge action, reweighting Metropolis against
    S_g + S_f - S_eff with the exact fermion action — SLMC without
    learning."""
    return SLMC(action, beta_eff=beta_eff, fermi_logdet=fermi_logdet,
                nsweeps=nsweeps, iteration_max=iteration_max, learn=False)


class _LogdetAsFermiAction:
    """Adapts a deterministic U -> S_f callable to the FermiAction
    protocol consumed by SLHMC.step (no pseudofermions: sampling
    returns S_f(U) with an empty eta, action ignores eta)."""

    def __init__(self, fermi_logdet):
        self._sf = fermi_logdet

    def sample_pseudofermion(self, u, key):
        return jnp.real(self._sf(u)), ()

    def action(self, u, eta):
        return jnp.real(self._sf(u))


def _leading_coupling(action: ga.GaugeAction) -> float:
    """Initial beta_eff default: the true action's leading coupling
    (the reference defaults beta_eff to beta, parameter_structs.jl:50)."""
    if action.plaq_coeff:
        return 2.0 * action.plaq_coeff
    if action.terms:
        return 2.0 * action.terms[0][0]
    return 5.7
