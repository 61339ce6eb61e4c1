import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from latticeqcd_tpu.io import load_bridge_text
from latticeqcd_tpu.ops import fields, gauge_action as ga, sun
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
from latticeqcd_tpu.updates import HMC

LAT = (4, 4, 4, 4)


def _u():
    return fields.hot_start(LAT, 3, seed=21)


def _fd_check(fa, u, key, tol=2e-4):
    """dS_f/dt along a random algebra direction == -2 tr(H F)."""
    s_old, phi = fa.sample_pseudofermion(u, key)
    h = sun.random_hermitian_momentum(jax.random.PRNGKey(99), u.shape[:-2], 3)

    def s_along(t):
        e = sun.expi_hermitian(h, t)
        ut = jnp.stack([sun.mul(e[mu], u[mu]) for mu in range(4)])
        return float(fa.action(ut, phi))

    dt = 1e-4
    ds_num = (s_along(dt) - s_along(-dt)) / (2 * dt)
    f = fa.force(u, phi)
    ds_force = -2.0 * float(jnp.sum(jnp.real(sun.trace(sun.mul(h, f)))))
    assert abs(ds_num - ds_force) < tol * max(1.0, abs(ds_num)), (ds_num, ds_force)


def test_wilson_force_finite_difference():
    fa = WilsonFermiAction(WilsonDirac(kappa=0.141139), eps_cg=1e-24)
    _fd_check(fa, _u(), jax.random.PRNGKey(0))


def test_staggered_nf4_force_finite_difference():
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=4, eps_cg=1e-24)
    _fd_check(fa, _u(), jax.random.PRNGKey(1))


def test_staggered_nf3_rhmc_force_finite_difference():
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=3, eps_cg=1e-24)
    _fd_check(fa, _u(), jax.random.PRNGKey(2))


@pytest.mark.slow
def test_staggered_nf6_two_pf_force_finite_difference():
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=6, eps_cg=1e-24)
    _fd_check(fa, _u(), jax.random.PRNGKey(3))


@pytest.mark.parametrize("nf", [1, 2, 3, 4, 5, 8])
def test_staggered_sampling_action_consistency(nf):
    """S_f(phi; U) right after sampling must equal |xi|^2 (up to the
    rational tolerance) — validates the W^(Nf/8) / W^(-Nf/4) adjoint
    pair and the multishift solver end to end."""
    u = _u()
    fa = StaggeredFermiAction(
        StaggeredDirac(mass=0.5, lattice=LAT), nf=nf, eps_cg=1e-26, rational_tol=1e-12
    )
    s_old, phi = fa.sample_pseudofermion(u, jax.random.PRNGKey(4))
    s_eval = fa.action(u, phi)
    assert abs(float(s_old) - float(s_eval)) < 1e-6 * float(s_old), (nf, float(s_old), float(s_eval))


def test_wilson_sampling_action_consistency():
    u = _u()
    fa = WilsonFermiAction(WilsonDirac(kappa=0.141139), eps_cg=1e-26)
    s_old, phi = fa.sample_pseudofermion(u, jax.random.PRNGKey(5))
    s_eval = fa.action(u, phi)
    assert abs(float(s_old) - float(s_eval)) < 1e-8 * float(s_old)


@pytest.mark.slow
def test_wilson_hmc_golden(reference_dir):
    """test_wilson scenario: SW nested leapfrog, kappa=0.141139,
    golden plaquette 0.5784043949012552 at 10% (BASELINE.md #7)."""
    conf = os.path.join(
        reference_dir,
        "test/confs_HMC_L04040404_beta5.7_Wilson_kappa0.141139/conf_00000100.ildg.txt",
    )
    u = load_bridge_text(conf, LAT, 3)
    fa = WilsonFermiAction(WilsonDirac(kappa=0.141139), eps_cg=1e-19)
    hmc = HMC(
        action=ga.wilson_gauge_action(3, 5.7),
        dtau=0.05,
        md_steps=20,
        sexton_weingarten=True,
        nsw=10,
        fermi_action=fa,
    )
    key = jax.random.PRNGKey(111)
    n_acc = 0
    for _ in range(10):
        u, key, st = hmc.step(u, key)
        n_acc += int(st["accepted"])
    plaq = float(ga.mean_plaquette(u))
    golden = 0.5784043949012552
    assert abs(plaq - golden) / golden < 0.1, plaq
    assert n_acc >= 5


@pytest.mark.slow
def test_staggered_nf4_hmc_golden(reference_dir):
    """test_staggered scenario: Nf=4 mass=0.5, golden 0.5734383856968012."""
    conf = os.path.join(
        reference_dir,
        "test/confs_HMC_L04040404_beta5.7_Staggered_mass0.5/conf_00000100.ildg.txt",
    )
    u = load_bridge_text(conf, LAT, 3)
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=4, eps_cg=1e-19)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.025, md_steps=40, fermi_action=fa)
    key = jax.random.PRNGKey(111)
    n_acc = 0
    for _ in range(10):
        u, key, st = hmc.step(u, key)
        n_acc += int(st["accepted"])
    plaq = float(ga.mean_plaquette(u))
    golden = 0.5734383856968012
    assert abs(plaq - golden) / golden < 0.1, plaq
    assert n_acc >= 5


@pytest.mark.slow
@pytest.mark.parametrize(
    "nf,confdir,golden",
    [
        (2, "confs_HMC_L04040404_beta5.7_Staggered_mass0.5_Nf2", 0.56287171870089),
        (3, "confs_HMC_L04040404_beta5.7_Staggered_mass0.5_Nf3", 0.5595757232711884),
    ],
)
def test_staggered_rhmc_golden(reference_dir, nf, confdir, golden):
    """test_Nf2/test_Nf3: RHMC (BASELINE.md #9, #10)."""
    conf = os.path.join(reference_dir, "test", confdir, "conf_00000100.ildg.txt")
    u = load_bridge_text(conf, LAT, 3)
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=nf, eps_cg=1e-19)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=20, fermi_action=fa)
    key = jax.random.PRNGKey(111)
    n_acc = 0
    for _ in range(10):
        u, key, st = hmc.step(u, key)
        n_acc += int(st["accepted"])
    plaq = float(ga.mean_plaquette(u))
    assert abs(plaq - golden) / golden < 0.1, plaq
    assert n_acc >= 5


def test_rhmc_spectral_bound_check():
    """Power-iteration lambda_max(W) vs dense eigenvalues, and the
    adaptive window widening (VERDICT r1 weak #6)."""
    u = _u()
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=2)
    lam = float(fa.lambda_max_w(u, 60))

    # dense W on even sites (dim = V/2 * NC = 384 at 4^4): exact lambda_max
    from latticeqcd_tpu.ops.dirac.wilson import apply_boundary_phases

    up = apply_boundary_phases(u, fa.dirac.bc)
    ueo = fa.dirac.packed_links(up)
    half = (LAT[0] // 2,) + LAT[1:] + (3,)
    dim = int(np.prod(half))
    eye = jnp.eye(dim, dtype=u.dtype).reshape((dim,) + half)
    cols = jax.vmap(lambda v: fa.dirac.apply_w_packed(ueo, v))(eye)
    wmat = np.asarray(cols.reshape(dim, dim)).T
    lam_exact = float(np.linalg.eigvalsh(0.5 * (wmat + wmat.conj().T)).max())
    assert abs(lam - lam_exact) < 0.02 * lam_exact, (lam, lam_exact)

    lo, hi = fa._bounds()
    assert lo <= lam_exact <= hi  # free-field bound holds on a hot config

    # window already valid -> unchanged object
    fa2, _ = fa.ensure_spectral_bounds(u)
    assert fa2 is fa

    # force a violation -> widened copy whose window covers lambda*safety
    fa3, lam3 = fa.ensure_spectral_bounds(u, safety=100.0)
    assert fa3 is not fa
    assert fa3._bounds()[1] >= 100.0 * lam3 * 0.999
    # the widened action still evaluates (rational rebuilt on new window)
    _, phi = fa3.sample_pseudofermion(u, jax.random.PRNGKey(0))
    assert np.isfinite(float(fa3.action(u, phi)))


@pytest.mark.slow
def test_hasenbusch_sampling_action_consistency():
    """Hasenbusch split: S1 + S2 right after sampling = |xi1|^2 +
    |xi2|^2 — validates A_mu A_mu^dag = AA^dag + mu^2 (twisted-g5
    identity) and the phi2 = A_mu^-dag A xi2 sampling solve, on both
    the packed-Schur and the full-volume (clover) operator paths."""
    from latticeqcd_tpu.ops.fermion_action import HasenbuschWilsonFermiAction

    u = _u()
    for csw in (0.0, 1.5612):
        fa = HasenbuschWilsonFermiAction(
            WilsonDirac(kappa=0.141139, csw=csw), mu=0.5, eps_cg=1e-26
        )
        s_old, phi = fa.sample_pseudofermion(u, jax.random.PRNGKey(6))
        s_eval = fa.action(u, phi)
        assert abs(float(s_old) - float(s_eval)) < 1e-7 * float(s_old), (
            csw, float(s_old), float(s_eval))


def test_hasenbusch_force_finite_difference():
    from latticeqcd_tpu.ops.fermion_action import HasenbuschWilsonFermiAction

    fa = HasenbuschWilsonFermiAction(
        WilsonDirac(kappa=0.141139), mu=0.5, eps_cg=1e-24
    )
    _fd_check(fa, _u(), jax.random.PRNGKey(7))


@pytest.mark.slow
def test_hasenbusch_hmc_dh_vs_plain():
    """At the same step size the Hasenbusch-split trajectory conserves
    H at least as well as the plain 2f action (force-fluctuation
    reduction), and the update runs end to end on the fused path."""
    u = _u()
    act = ga.wilson_gauge_action(3, 5.7)
    from latticeqcd_tpu.ops.fermion_action import HasenbuschWilsonFermiAction

    key = jax.random.PRNGKey(8)
    plain = HMC(action=act, dtau=0.1, md_steps=5, staged=False,
                fermi_action=WilsonFermiAction(WilsonDirac(kappa=0.141139),
                                               eps_cg=1e-20))
    hasen = HMC(action=act, dtau=0.1, md_steps=5, staged=False,
                fermi_action=HasenbuschWilsonFermiAction(
                    WilsonDirac(kappa=0.141139), mu=0.5, eps_cg=1e-20))
    _, _, st_p = plain.step(u, key)
    _, _, st_h = hasen.step(u, key)
    assert bool(jnp.isfinite(st_h["dH"]))
    assert abs(float(st_h["dH"])) < 2.0 * abs(float(st_p["dH"])) + 0.05, (
        float(st_h["dH"]), float(st_p["dH"]))


def test_hasenbusch_force_terms_sum_to_total():
    """force_heavy + force_light == force (the split is exact)."""
    from latticeqcd_tpu.ops.fermion_action import HasenbuschWilsonFermiAction

    u = _u()
    fa = HasenbuschWilsonFermiAction(WilsonDirac(kappa=0.141139), mu=0.5, eps_cg=1e-24)
    _, phi = fa.sample_pseudofermion(u, jax.random.PRNGKey(12))
    f_tot = fa.force(u, phi)
    f_sum = fa.force_heavy(u, phi) + fa.force_light(u, phi)
    assert float(jnp.max(jnp.abs(f_tot - f_sum))) < 1e-9


@pytest.mark.slow
def test_hasenbusch_sw_split_staged_matches_fused():
    """SW + Hasenbusch: the heavy term integrates on the fine gauge
    scale (force_fine), light on the coarse; staged = fused."""
    from latticeqcd_tpu.ops.fermion_action import HasenbuschWilsonFermiAction

    u = _u()
    act = ga.wilson_gauge_action(3, 5.7)
    fa = HasenbuschWilsonFermiAction(WilsonDirac(kappa=0.141139), mu=1.0, eps_cg=1e-20)
    kw = dict(action=act, dtau=0.1, md_steps=2, sexton_weingarten=True,
              nsw=2, fermi_action=fa)
    key = jax.random.PRNGKey(13)
    fused = HMC(staged=False, **kw)
    staged = HMC(staged=True, **kw)
    u1, _, st1 = fused.step(u, key)
    u2, _, st2 = staged.step(u, key)
    assert bool(jnp.isfinite(st1["dH"]))
    assert abs(float(st1["dH"]) - float(st2["dH"])) < 1e-7
    assert bool(st1["accepted"]) == bool(st2["accepted"])


def test_c64_dynamical_step_preserves_dtype_under_x64():
    """Strongly-typed NumPy scalars (np.sqrt(2.0)) used to promote
    complex64 fields to complex128 under x64 mode — invisible with x64
    off and in the f64 test suite, but it silently doubled memory and
    ran f64 math in complex64 runs (found by scripts/c64_bias.py)."""
    u = fields.hot_start(LAT, 3, seed=100, dtype=jnp.complex64)
    from latticeqcd_tpu.ops import sun
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction

    h = sun.random_hermitian_momentum(jax.random.PRNGKey(0), LAT, 3, dtype=jnp.complex64)
    assert h.dtype == jnp.complex64
    assert sun.expi_hermitian(h, 0.1).dtype == jnp.complex64
    fa = WilsonFermiAction(WilsonDirac(kappa=0.141139, r=1.0), eps_cg=1e-10, max_cg=500)
    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=2,
              fermi_action=fa, staged=False)
    u2, _, st = hmc.step(u, jax.random.PRNGKey(1))
    assert u2.dtype == jnp.complex64
    assert bool(jnp.isfinite(st["dH"]))


def test_c64_dtype_preserved_all_fermion_families():
    """Pseudofermion sampling + force keep complex64 under x64 for
    every fermion family (domain-wall g5 projector and RHMC rational
    coefficients used to promote to complex128)."""
    from latticeqcd_tpu.ops import fields
    from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac
    from latticeqcd_tpu.ops.fermion_action import (
        DomainwallFermiAction,
        StaggeredFermiAction,
        WilsonFermiAction,
    )

    u4 = fields.hot_start((4, 4, 4, 4), 3, seed=1, dtype=jnp.complex64)
    udw = fields.hot_start((4, 4, 2, 2), 3, seed=1, dtype=jnp.complex64)
    cases = [
        (WilsonFermiAction(WilsonDirac(kappa=0.13), eps_cg=1e-8, max_cg=300), u4),
        (WilsonFermiAction(WilsonDirac(kappa=0.13, csw=1.5612), eps_cg=1e-8, max_cg=300), u4),
        (StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=(4, 4, 4, 4)),
                              nf=2, eps_cg=1e-8, max_cg=300), u4),
        (DomainwallFermiAction(DomainwallDirac(mass=0.5, m5=1.0, l5=4),
                               eps_cg=1e-8, max_cg=300), udw),
    ]
    for fa, u in cases:
        _, phi = fa.sample_pseudofermion(u, jax.random.PRNGKey(0))
        assert phi.dtype == jnp.complex64, type(fa).__name__
        assert fa.force(u, phi).dtype == jnp.complex64, type(fa).__name__
