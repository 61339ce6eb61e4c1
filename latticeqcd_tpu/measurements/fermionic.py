"""Fermionic measurements: chiral condensate, pion correlator.

Mirrors the reference's archived kernels (SURVEY.md 2.4.3):

* Chiral condensate (measure_chiral_condensate.jl:164-204): Nr Z4
  noise vectors r, pbp = <Re <r, D^-1 r>>/NV * factor, factor = Nf/4
  for staggered (Nfbase taste counting, :45-56), 1 for Wilson.
* Pion correlator (measure_Pion_correlator.jl:188-330): NC*Nspinor
  point-source inversions at the origin, S_beta^alpha(x), and
  C_pi(t) = sum_x,alpha,beta |S|^2 via gamma5-hermiticity. (The
  archived loop indexes the sink with the source's spin-color —
  an apparent transcription bug; we implement the standard full
  sink-index sum.)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from latticeqcd_tpu.ops import solvers
from latticeqcd_tpu.ops.dirac.gammas import GAMMA5
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
from latticeqcd_tpu.ops.dirac.wilson import (
    WilsonDirac,
    apply_boundary_phases,
    inner,
    z4_spinor,
)


def _solve_mode():
    """Test hook: LQCD_FORCE_SOLVE_MODE=batched|sequential overrides the
    cg_multi_auto backend dispatch (read at trace time — tests using it
    must use a shape not already in the jit cache)."""
    import os

    return os.environ.get("LQCD_FORCE_SOLVE_MODE") or None


@partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _solve_dinv_multi(dirac, up, b, eps, maxiter, deflate_k=0):
    """solve_DinvX! over a STACK of right-hand sides: D x_i = b_i,
    b shape (n, *lattice, [spin,] color); one jitted SPMD program per
    (operator, shape).

    The batch runs through solvers.cg_multi_auto: on accelerators the
    operator is vmapped over the RHS axis so the HBM-bound Dirac
    mat-vec reads the link field once per batch instead of once per
    source (PERF.md roofline — links are ~3/5 of D-slash traffic), the
    batched answer to the reference's sequential NC*Nspinor
    measurement inversions (measure_Pion_correlator.jl:333-409); on
    CPU a sequential lax.scan of single-RHS CGs measures 1.40x faster
    (cache-resident working set, per-RHS early exit).

    Staggered fast path: even-odd Schur decomposition in the PACKED
    layout (see StaggeredDirac.apply_w_packed) — with D = m + Dsl and
    Dsl parity-off-diagonal,
        (m^2 - Dsl_eo Dsl_oe) x_e = m b_e - Dsl_eo b_o,
        x_o = (b_o - Dsl_oe x_e) / m,
    so the CG runs on half-volume fields with the same spectral bounds.
    Wilson uses the packed even-odd Schur form of D itself; clover /
    m=0 / odd-extent lattices use full-volume CGNE."""
    if (
        isinstance(dirac, StaggeredDirac)
        and dirac.mass != 0.0
        and all(l % 2 == 0 for l in dirac.lattice)
    ):
        d = dirac
        u_e, u_o = d.packed_links(up)
        b_e = jax.vmap(lambda f: d.pack(f, 0))(b)
        b_o = jax.vmap(lambda f: d.pack(f, 1))(b)
        dsl_eo = jax.vmap(lambda v: d._packed_dslash(u_e, u_o, v, target_parity=0))
        dsl_oe = jax.vmap(lambda v: d._packed_dslash(u_o, u_e, v, target_parity=1))
        rhs_e = d.mass * b_e - dsl_eo(b_o)
        w_one = lambda v: d.apply_w_packed((u_e, u_o), v)  # noqa: E731
        x0 = None
        if deflate_k:
            # Low-mode deflated guess (opt-in, deflate_k > 0): one
            # Lanczos sweep of W amortizes over ALL RHS of the batch;
            # x0 projects out the k lowest Ritz modes. The guess only
            # seeds CG (eigen.deflation_guess), so results are
            # identical to the undeflated solve at the same eps.
            # MEASURED caveat (PERF.md "Low-mode deflation"): pays off
            # only when the low spectrum is sparse/separated; in the
            # chirally-broken phase the band is dense (Banks-Casher)
            # and the iteration count is unchanged — hence opt-in.
            from latticeqcd_tpu.ops import eigen

            m_lan = max(3 * deflate_k, deflate_k + 16)
            evals, vecs = eigen.ritz_pairs_low(w_one, rhs_e[0], m_lan, deflate_k)
            x0 = eigen.deflation_guess(evals, vecs, rhs_e)
        x_e, _, _ = solvers.cg_multi_auto(
            w_one,
            rhs_e, eps=eps, maxiter=maxiter, force_mode=_solve_mode(), x0=x0,
        )
        x_o = (b_o - dsl_oe(x_e)) / d.mass
        return jax.vmap(lambda v: d.unpack(v, 0))(x_e) + jax.vmap(
            lambda v: d.unpack(v, 1)
        )(x_o)
    if (
        isinstance(dirac, WilsonDirac)
        and dirac.csw != 0.0
        and all(l % 2 == 0 for l in up.shape[1:5])
    ):
        # Clover even-odd Schur: D = [[A_ee, -kH_eo],[-kH_oe, A_oo]]
        # with the site-local clover block A = 1 + T, so
        #   Dhat x_e = (A_ee - k^2 H_eo A_oo^-1 H_oe) x_e
        #            = b_e + k H_eo A_oo^-1 b_o,
        #   x_o = A_oo^-1 (b_o + k H_oe x_e);
        # CG on Dhat^dag Dhat (gamma5-hermitian) at half volume. The
        # batched 12x12 A_oo inversions amortize over all RHS and
        # iterations (wilson.py clover_packed_blocks).
        d = dirac
        lattice = tuple(up.shape[1:5])
        from latticeqcd_tpu.ops.dirac import eo_pack

        u_eo = d.packed_links(up)
        u_e, u_o = u_eo
        a_e, ainv_o = d.clover_packed_blocks(up)
        b_e = jax.vmap(lambda f: eo_pack.pack(f, lattice, 0))(b)
        b_o = jax.vmap(lambda f: eo_pack.pack(f, lattice, 1))(b)
        hop_eo = jax.vmap(lambda v: d.hop_packed(u_e, u_o, v, target_parity=0))
        hop_oe = jax.vmap(lambda v: d.hop_packed(u_o, u_e, v, target_parity=1))
        ainv = jax.vmap(lambda v: d.site_apply(ainv_o, v))
        dhat_dag = jax.vmap(lambda v: d.apply_dhat_clover_dagger(u_eo, a_e, ainv_o, v))
        rhs_e = dhat_dag(b_e + d.kappa * hop_eo(ainv(b_o)))
        x_e, _, _ = solvers.cg_multi_auto(
            lambda v: d.apply_dhat_clover_dagger(
                u_eo, a_e, ainv_o, d.apply_dhat_clover(u_eo, a_e, ainv_o, v)
            ),
            rhs_e, eps=eps, maxiter=maxiter, force_mode=_solve_mode(),
        )
        x_o = ainv(b_o + d.kappa * hop_oe(x_e))
        return jax.vmap(lambda v: eo_pack.unpack(v, lattice, 0))(x_e) + jax.vmap(
            lambda v: eo_pack.unpack(v, lattice, 1)
        )(x_o)
    if (
        isinstance(dirac, WilsonDirac)
        and dirac.csw == 0.0
        and all(l % 2 == 0 for l in up.shape[1:5])
    ):
        # Wilson Schur: D x = b with D = [[1,-kH_eo],[-kH_oe,1]] gives
        #   Dhat x_e = b_e + k H_eo b_o,   x_o = b_o + k H_oe x_e,
        # solved by CG on Dhat^dag Dhat (gamma5-hermitian) at half
        # volume and ~2.6x fewer iterations than full-volume CGNE.
        d = dirac
        lattice = tuple(up.shape[1:5])
        from latticeqcd_tpu.ops.dirac import eo_pack

        u_eo = d.packed_links(up)
        u_e, u_o = u_eo
        b_e = jax.vmap(lambda f: eo_pack.pack(f, lattice, 0))(b)
        b_o = jax.vmap(lambda f: eo_pack.pack(f, lattice, 1))(b)
        hop_eo = jax.vmap(lambda v: d.hop_packed(u_e, u_o, v, target_parity=0))
        hop_oe = jax.vmap(lambda v: d.hop_packed(u_o, u_e, v, target_parity=1))
        dhat_dag = jax.vmap(lambda v: d.apply_dhat_dagger(u_eo, v))
        rhs_e = dhat_dag(b_e + d.kappa * hop_eo(b_o))
        x_e, _, _ = solvers.cg_multi_auto(
            lambda v: d.apply_dhat_dagger(u_eo, d.apply_dhat(u_eo, v)),
            rhs_e, eps=eps, maxiter=maxiter, force_mode=_solve_mode(),
        )
        x_o = b_o + d.kappa * hop_oe(x_e)
        return jax.vmap(lambda v: eo_pack.unpack(v, lattice, 0))(x_e) + jax.vmap(
            lambda v: eo_pack.unpack(v, lattice, 1)
        )(x_o)
    rhs = jax.vmap(lambda f: dirac.apply_dagger(up, f))(b)
    x, it, rsq = solvers.cg_multi_auto(
        lambda v: dirac.apply_ddag_d(up, v), rhs, eps=eps, maxiter=maxiter,
        force_mode=_solve_mode(),
    )
    return x


def _solve_dinv(dirac, up, b, eps, maxiter):
    """Single-RHS solve_DinvX!: D x = b (batched path with n = 1)."""
    return _solve_dinv_multi(dirac, up, b[None], eps, maxiter)[0]


@partial(jax.jit, static_argnums=(0, 3, 4))
def _dw_effective_propagator_multi(dirac, up, b4, eps, maxiter):
    """4D effective quark propagator of the Shamir domain-wall operator
    applied to a stack of 4D sources: q_i = S_F b_i.

    BEYOND the reference: its domain-wall pion measurement errors out
    ("Domainwall fermion is not implemented in Pion measurement!",
    measure_Pion_correlator.jl:171) and its DW chiral condensate is
    archived dead code (measurements/unusedfiles/). Standard
    construction: the physical quark fields live on the walls,
        q = P- psi_0 + P+ psi_{L5-1},
        qbar = psibar_0 P+ + psibar_{L5-1} P-,
    so S_F b = P- X_0 + P+ X_{L5-1} with D_dw(m) X = B,
    B_s = delta_{s,0} P+ b + delta_{s,L5-1} P- b. The 5D solves run on
    the packed even-odd Schur operator (domainwall.py apply_schur) on
    all-even lattices — the same half-volume hot path HMC uses — and
    batch over RHS through cg_multi_auto."""
    lattice = tuple(up.shape[1:5])
    l5 = dirac.l5
    rdt = jnp.float64 if b4.dtype == jnp.complex128 else jnp.float32
    g5 = jnp.asarray(np.diag(np.asarray(GAMMA5)).real, dtype=rdt)
    p_plus = ((1.0 + g5) / 2.0)[:, None]
    p_minus = ((1.0 - g5) / 2.0)[:, None]

    def wall_source(b):  # (X,Y,Z,T,4,NC) -> (L5,X,Y,Z,T,4,NC)
        b5 = jnp.zeros((l5,) + b.shape, dtype=b.dtype)
        b5 = b5.at[0].set(p_plus * b)
        return b5.at[l5 - 1].set(p_minus * b)

    b5 = jax.vmap(wall_source)(b4)
    if all(l % 2 == 0 for l in lattice):
        d = dirac
        ueo = d.packed_links(up)
        u_e, u_o = ueo
        b_e = jax.vmap(lambda f: d.pack5(f, lattice, 0))(b5)
        b_o = jax.vmap(lambda f: d.pack5(f, lattice, 1))(b5)
        hop_eo = jax.vmap(lambda v: d._packed_hop(u_e, u_o, v, target_parity=0))
        hop_oe = jax.vmap(lambda v: d._packed_hop(u_o, u_e, v, target_parity=1))
        ainv = jax.vmap(d.apply_a_inv)
        rhs_e = b_e - hop_eo(ainv(b_o))
        sdag = jax.vmap(lambda v: d.apply_schur_dagger(ueo, v))
        x_e, _, _ = solvers.cg_multi_auto(
            lambda v: d.apply_schur_dagger(ueo, d.apply_schur(ueo, v)),
            sdag(rhs_e), eps=eps, maxiter=maxiter, force_mode=_solve_mode(),
        )
        x_o = ainv(b_o - hop_oe(x_e))
        x5 = jax.vmap(lambda v: d.unpack5(v, lattice, 0))(x_e) + jax.vmap(
            lambda v: d.unpack5(v, lattice, 1)
        )(x_o)
    else:
        rhs = jax.vmap(lambda f: dirac.apply_dagger(up, f))(b5)
        x5, _, _ = solvers.cg_multi_auto(
            lambda v: dirac.apply_ddag_d(up, v), rhs, eps=eps,
            maxiter=maxiter, force_mode=_solve_mode(),
        )
    return p_minus * x5[:, 0] + p_plus * x5[:, l5 - 1]


def _is_domainwall(dirac) -> bool:
    return hasattr(dirac, "l5")


def chiral_condensate(u, dirac, key, nr: int = 10, nf_factor: float = 1.0,
                      eps: float = 1e-19, maxiter: int = 3000,
                      deflate_k: int = 0):
    """Returns (pbp_value, per-noise list).

    deflate_k > 0 (staggered even-odd path only): seed the batched CG
    with a k-lowest-Ritz-mode Galerkin guess (ops/eigen.py) — one
    Lanczos sweep amortized over all nr noise solves; results are
    identical either way. Helps only when the low spectrum is sparse
    (see the measured caveat in _solve_dinv_multi / PERF.md)."""
    up = apply_boundary_phases(u, dirac.bc)
    lattice = u.shape[1:5]
    nc = u.shape[-1]
    nspin = 1 if isinstance(dirac, StaggeredDirac) else 4
    nv = int(np.prod(lattice))
    # same per-noise subkey sequence as the historical sequential loop
    subs = []
    for _ in range(nr):
        key, sub = jax.random.split(key)
        subs.append(sub)
    r = jnp.stack(
        [z4_spinor(s, lattice, nc, nspin=nspin, dtype=u.dtype) for s in subs]
    )
    if _is_domainwall(dirac):
        # <qbar q> of the 4D effective (wall-to-wall) propagator; the
        # standard DW contact term is not subtracted (documented
        # convention — the reference has no working DW condensate to
        # pin against, measurements/unusedfiles/)
        p = _dw_effective_propagator_multi(dirac, up, r, eps, maxiter)
    else:
        p = _solve_dinv_multi(dirac, up, r, eps, maxiter, deflate_k)
    axes = tuple(range(1, r.ndim))
    per_noise = jnp.real(jnp.sum(jnp.conj(r) * p, axis=axes))
    vals = [float(v) / nv for v in per_noise]
    pbp = float(jnp.sum(per_noise)) / nr / nv * nf_factor
    return pbp, vals


@partial(jax.jit, static_argnums=(0, 2, 3))
def _low_spectrum_jit(dirac, up, m, k):
    """Jitted body of dirac_low_spectrum: one program per
    (operator, lattice, m, k) — the Lanczos sweep, the small
    tridiagonal eigh and the Ritz rotation all run on device."""
    from latticeqcd_tpu.ops import eigen
    from latticeqcd_tpu.ops.dirac.wilson import gaussian_spinor

    lattice = up.shape[1:5]
    nc = up.shape[-1]
    if (
        isinstance(dirac, StaggeredDirac)
        and dirac.mass != 0.0
        and all(l % 2 == 0 for l in dirac.lattice)
    ):
        ueo = dirac.packed_links(up)
        v0 = gaussian_spinor(jax.random.PRNGKey(20260822), lattice, nc,
                             nspin=1, dtype=up.dtype)
        v0 = dirac.pack(jnp.where(dirac.even_mask[..., None], v0, 0.0), 0)
        vals, _ = eigen.ritz_pairs_low(
            lambda v: dirac.apply_w_packed(ueo, v), v0, m, k)
        return vals
    nspin = 1 if isinstance(dirac, StaggeredDirac) else 4
    if _is_domainwall(dirac):
        # 5D field: one independent Gaussian 4D spinor per s slice
        v0 = jnp.stack([
            gaussian_spinor(jax.random.PRNGKey(20260822 + s), lattice, nc,
                            nspin=4, dtype=up.dtype)
            for s in range(dirac.l5)
        ])
    else:
        v0 = gaussian_spinor(jax.random.PRNGKey(20260822), lattice, nc,
                             nspin=nspin, dtype=up.dtype)
    vals, _ = eigen.ritz_pairs_low(
        lambda v: dirac.apply_ddag_d(up, v), v0, m, k)
    return vals


def dirac_low_spectrum(u, dirac, k: int = 8, m: int = None):
    """Ritz estimates of the k lowest eigenvalues of the Hermitian PSD
    operator behind the measurement solves (ascending numpy array).

    Beyond-reference capability (LatticeQCD.jl ships no eigensolver):
    * staggered, even extents, m != 0: the packed even-odd
      W = m^2 - Dslash^2 — the anti-hermitian Dslash eigenvalues are
      +- i sqrt(lam - m^2), so the returned lam map directly onto the
      infrared Dirac spectrum whose density at zero ties the chiral
      condensate to Banks-Casher (pbp = pi rho(0) / V in the broken
      phase).
    * otherwise: D^dag D (squared singular values of D; for the
      gamma5-hermitian Wilson operator these are |eig(gamma5 D)|^2).

    Ritz values approach the true eigenvalues from inside after
    m >> k Lanczos steps (default m = max(6k, 48), full
    reorthogonalization, ops/eigen.py); quote them as estimates, and
    raise m to tighten. In the chirally broken phase the low band is
    dense (PERF.md "Low-mode deflation"), so individual values carry
    less meaning than their density."""
    if m is None:
        m = max(6 * k, 48)
    up = apply_boundary_phases(u, dirac.bc)
    return np.sort(np.asarray(_low_spectrum_jit(dirac, up, int(m), int(k)),
                              dtype=np.float64))


def pion_correlator(u, dirac, eps: float = 1e-19, maxiter: int = 3000,
                    deflate_k: int = 0):
    """C_pi(t) from point-source propagators at the origin.

    deflate_k: see chiral_condensate — low-mode deflated CG seed for
    the staggered even-odd path (opt-in)."""
    up = apply_boundary_phases(u, dirac.bc)
    lattice = u.shape[1:5]
    nc = u.shape[-1]
    nspin = 1 if isinstance(dirac, StaggeredDirac) else 4
    # all NC*Nspinor point sources in one batched solve: the links are
    # read once per batched mat-vec instead of once per source
    if nspin == 1:
        b = jnp.zeros((nc,) + tuple(lattice) + (nc,), dtype=u.dtype)
        for ic in range(nc):
            b = b.at[ic, 0, 0, 0, 0, ic].set(1.0)
    else:
        b = jnp.zeros((nspin * nc,) + tuple(lattice) + (nspin, nc), dtype=u.dtype)
        for ic in range(nc):
            for isp in range(nspin):
                b = b.at[ic * nspin + isp, 0, 0, 0, 0, isp, ic].set(1.0)
    if _is_domainwall(dirac):
        # 4D effective propagator (gamma5-hermitian, so C_pi = sum|S|^2
        # still holds); see _dw_effective_propagator_multi
        prop = _dw_effective_propagator_multi(dirac, up, b, eps, maxiter)
    else:
        prop = _solve_dinv_multi(dirac, up, b, eps, maxiter, deflate_k)
    # sum over source batch, sink indices and space: |S|^2 per time slice
    mag2 = jnp.abs(prop) ** 2
    axes = (0, 1, 2, 3) + tuple(range(5, mag2.ndim))
    return np.asarray(jnp.sum(mag2, axis=axes).astype(jnp.float64))
