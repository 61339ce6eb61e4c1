"""Mixed-precision MD (md_precision='mixed', ops/mdpair.py).

Motivation (VERDICT r4 weak #2 / next #3): the measured complex64 dH
offset at 8^4 was localized to c64 rounding in the integrator
arithmetic (exp(i eps H) U products + kick accumulation). Mixed mode
runs the MD state in f64 real pairs — never materializing complex128
— while forces/solves/links stay c64.

Pinned here:
  * pair algebra (exp map, matmul, KE) matches the complex128
    reference implementations at f64 precision;
  * on an identical trajectory start, mixed-c64 MD tracks the full
    complex128 trajectory ~an order of magnitude closer than plain
    c64 MD (the arithmetic the fix targets);
  * fused/staged/batched paths agree with each other in mixed mode;
  * the MDprecision TOML key plumbs through, and mixed without x64
    raises on every path.
"""

import jax
import jax.numpy as jnp
import pytest

from latticeqcd_tpu.md import integrators
from latticeqcd_tpu.ops import fields, gauge_action as ga, mdpair, sun
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction
from latticeqcd_tpu.updates import HMC

LAT = (4, 4, 4, 4)


def _state(seed=5, lat=LAT, dtype=jnp.complex128):
    u = fields.hot_start(lat, 3, seed=seed).astype(dtype)
    h = sun.random_hermitian_momentum(
        jax.random.PRNGKey(seed + 1), u.shape[:-2], 3, dtype=dtype
    )
    return u, h


def test_pair_expi_matches_ch():
    u, h = _state()
    for eps in (0.05, 0.7, 3.0):
        e_ref = sun.expi_hermitian(h, eps)
        e_pair = mdpair.lower(mdpair.expi_hermitian(mdpair.lift(h), eps))
        assert float(jnp.max(jnp.abs(e_pair - e_ref))) < 1e-12, eps


def test_pair_update_links_and_ke():
    u, h = _state()
    u1 = integrators.update_links(u, h, 0.05)
    u2 = mdpair.lower(integrators.update_links(mdpair.lift(u), mdpair.lift(h), 0.05))
    assert float(jnp.max(jnp.abs(u1 - u2))) < 1e-12
    ke = float(sun.kinetic_energy(h))
    assert abs(float(mdpair.kinetic_energy(mdpair.lift(h))) - ke) < 1e-9 * abs(ke)


def test_pair_lower_never_builds_complex128():
    """Lowering a c64 pair must not materialize a complex128 array even
    transiently (checked in the jaxpr)."""
    u, _ = _state(dtype=jnp.complex64)
    jaxpr = jax.make_jaxpr(mdpair.lower)(mdpair.lift(u))
    assert "complex128" not in str(jaxpr)


def test_mixed_md_tracks_f64_trajectory():
    """Same (U, H) start: mixed-c64 MD must land far closer to the
    complex128 trajectory than plain c64 MD does (quenched, so the
    only noise IS the integrator arithmetic under test; measured
    ~20x improvement at 6^4 dynamical, see PERF.md)."""
    u, h = _state(seed=9)
    fg128 = lambda uu: ga.force(ga.wilson_gauge_action(3, 5.7), mdpair.as_complex(uu))
    u_ref, _ = integrators.run_md(u, h, fg128, 0.05, 5)
    u_pl, _ = integrators.run_md(
        u.astype(jnp.complex64), h.astype(jnp.complex64), fg128, 0.05, 5)
    up, hp = mdpair.lift(u.astype(jnp.complex64)), mdpair.lift(h.astype(jnp.complex64))
    u_mx, _ = integrators.run_md(up, hp, fg128, 0.05, 5)
    dev_plain = float(jnp.max(jnp.abs(u_pl.astype(jnp.complex128) - u_ref)))
    dev_mixed = float(jnp.max(jnp.abs(
        mdpair.lower(u_mx).astype(jnp.complex128) - u_ref)))
    assert dev_mixed < dev_plain / 5.0, (dev_plain, dev_mixed)
    # and the c64-rounded start alone bounds the mixed deviation scale
    assert dev_mixed < 5e-6, dev_mixed


@pytest.mark.parametrize("scheme", ["QPQ", "PQP", "Omelyan"])
def test_mixed_staged_matches_fused(scheme):
    """Mixed mode must hold the staged==fused contract like plain mode
    (forces are evaluated at the same lowered points on both paths)."""
    u = fields.hot_start(LAT, 3, seed=91).astype(jnp.complex64)
    key = jax.random.PRNGKey(3)
    act = ga.wilson_gauge_action(3, 5.7)
    fused = HMC(action=act, dtau=0.05, md_steps=4, scheme=scheme,
                md_precision="mixed", staged=False)
    staged = HMC(action=act, dtau=0.05, md_steps=4, scheme=scheme,
                 md_precision="mixed", staged=True)
    u1, _, st1 = fused.step(u, key)
    u2, _, st2 = staged.step(u, key)
    # quenched mixed: both paths run identical f64 arithmetic up to
    # the merged-half-step reassociation — exp(h, dtau) vs
    # exp(h, dtau/2)^2 differ at f64 rounding per step, which dH (a
    # cancellation of O(1e4) sums) amplifies to ~1e-9..1e-8
    assert abs(float(st1["dH"]) - float(st2["dH"])) < 1e-7
    assert bool(st1["accepted"]) == bool(st2["accepted"])
    assert float(jnp.max(jnp.abs(u1 - u2))) < 1e-6  # c64 storage


@pytest.mark.slow
def test_mixed_dynamical_staged_matches_fused():
    u = fields.hot_start(LAT, 3, seed=92).astype(jnp.complex64)
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=4,
                              eps_cg=1e-14)
    act = ga.wilson_gauge_action(3, 5.7)
    key = jax.random.PRNGKey(4)
    fused = HMC(action=act, dtau=0.05, md_steps=3, fermi_action=fa,
                md_precision="mixed", staged=False)
    staged = HMC(action=act, dtau=0.05, md_steps=3, fermi_action=fa,
                 md_precision="mixed", staged=True)
    _, _, st1 = fused.step(u, key)
    _, _, st2 = staged.step(u, key)
    # dynamical: forces see c64-lowered links on both paths, but the
    # merged-program staged structure evaluates them after a merged
    # f64 drift — agreement at the c64 force-noise scale
    assert abs(float(st1["dH"]) - float(st2["dH"])) < 5e-4
    assert float(st1["sf_new"]) == pytest.approx(float(st2["sf_new"]), rel=1e-5)


def test_mixed_step_batched_both_paths():
    """step_batched supports mixed on the fused (vmap) AND staged
    variants; chains match the single-chain result."""
    act = ga.wilson_gauge_action(3, 5.7)
    us = jnp.stack([fields.hot_start(LAT, 3, seed=s).astype(jnp.complex64)
                    for s in (3, 4)])
    keys = jnp.stack([jax.random.PRNGKey(1), jax.random.PRNGKey(2)])
    for staged in (False, True):
        hmc = HMC(action=act, dtau=0.05, md_steps=3, md_precision="mixed",
                  staged=staged)
        ub, _, stb = hmc.step_batched(us, keys)
        one = hmc._step_staged if staged else hmc._step_fused
        ui, _, sti = one(us[1], keys[1])
        assert abs(float(stb["dH"][1]) - float(sti["dH"])) < 1e-9
        assert float(jnp.max(jnp.abs(ub[1] - ui))) < 1e-7


def test_mixed_toml_key_plumbs_to_updater(tmp_path, monkeypatch):
    from latticeqcd_tpu.system.params import construct_params_from_toml
    from latticeqcd_tpu.system.universe import build_universe
    from latticeqcd_tpu.updates.factory import updatemethod

    monkeypatch.chdir(tmp_path)
    p = construct_params_from_toml(
        {"HMC related": {"MDprecision": "mixed", "MDsteps": 4}},
        make_dirs=False,
    )
    univ = build_universe(p, dtype=jnp.complex64)
    up = updatemethod(p, univ)
    assert up.md_precision == "mixed"
    with pytest.raises(ValueError, match="md_precision"):
        HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2,
            md_precision="bogus").step(univ.u, jax.random.PRNGKey(0))


def test_mixed_requires_x64():
    """Without x64 the pair state silently truncates to f32 — must
    raise identically on all paths (conftest enables x64; flip it
    off for the check and restore)."""
    u = fields.hot_start(LAT, 3, seed=1).astype(jnp.complex64)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2,
              md_precision="mixed")
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(RuntimeError, match="x64"):
            hmc.step(u, jax.random.PRNGKey(0))
        with pytest.raises(RuntimeError, match="x64"):
            hmc.step_batched(u[None], jax.random.PRNGKey(0)[None])
    finally:
        jax.config.update("jax_enable_x64", True)
