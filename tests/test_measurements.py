import os

import jax.numpy as jnp
import numpy as np
import pytest

from latticeqcd_tpu.io import load_bridge_text
from latticeqcd_tpu.measurements import MeasurementSet, fermionic, observables
from latticeqcd_tpu.ops import fields, gauge_action as ga
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac
from latticeqcd_tpu.smearing import gradientflow

LAT = (4, 4, 4, 4)


def test_polyakov_cold_is_one():
    u = fields.cold_start(LAT, 3)
    p = complex(observables.polyakov_loop(u))
    assert abs(p - 1.0) < 1e-13


def test_polyakov_gauge_invariant_magnitude():
    u = fields.hot_start(LAT, 3, seed=51)
    p = complex(observables.polyakov_loop(u))
    assert abs(p) < 1.0


def test_topological_charge_cold_zero():
    u = fields.cold_start(LAT, 3)
    for kind in ("plaquette", "clover", "improved"):
        assert abs(float(observables.topological_charge(u, kind))) < 1e-10


def test_topological_charge_instanton():
    """One-instanton SU(2) start carries |Q| ~ 1 once a short flow
    (t=0.1) removes the singular-gauge core artifact."""
    u = fields.one_instanton_start((8, 8, 8, 8), 2)
    gf = gradientflow(2, nflow=5, eps=0.02)
    uf = gf.flow(u)
    q = float(observables.topological_charge(uf, "improved"))
    assert 0.7 < abs(q) < 1.4, q


def test_energy_density_finite_and_decreases_under_flow():
    u = fields.hot_start(LAT, 3, seed=52)
    e0 = float(observables.energy_density(u))
    gf = gradientflow(3, nflow=10, eps=0.02)
    e1 = float(observables.energy_density(gf.flow(u)))
    assert np.isfinite(e0) and np.isfinite(e1)


def test_wilson_loop_cold_is_one():
    u = fields.cold_start(LAT, 3)
    for (r, t) in [(1, 1), (2, 1), (2, 2)]:
        assert abs(float(observables.wilson_loop_rt(u, r, t)) - 1.0) < 1e-12
    # 1x1 wilson loop == plaquette average on any config
    uh = fields.hot_start(LAT, 3, seed=53)
    w11 = float(observables.wilson_loop_rt(uh, 1, 1))
    # plaquette averages over 6 planes; w11 only over 3 spatial-temporal
    assert abs(w11) < 1.0


def test_pion_correlator_free_field_decays():
    u = fields.cold_start(LAT, 3)
    d = WilsonDirac(kappa=0.12)
    c = fermionic.pion_correlator(u, d, eps=1e-22)
    assert c.shape == (4,)
    assert c[0] > c[1] > 0
    # time reflection symmetry (periodic lattice, antiperiodic quark BC)
    assert abs(c[1] - c[3]) < 1e-6 * c[1]


def test_chiral_condensate_staggered_positive(reference_dir):
    conf = os.path.join(
        reference_dir,
        "test/confs_HMC_L04040404_beta5.7_Staggered_mass0.5/conf_00000100.ildg.txt",
    )
    u = load_bridge_text(conf, LAT, 3)
    d = StaggeredDirac(mass=0.5, lattice=LAT)
    import jax

    pbp, vals = fermionic.chiral_condensate(u, d, jax.random.PRNGKey(0), nr=4, nf_factor=1.0)
    assert len(vals) == 4
    # heavy staggered quark: pbp ~ Nc * <1/(m + ...)> > 0
    assert 0.5 < pbp < 6.0, pbp


def test_measurement_set_scheduling_and_files(tmp_path, reference_dir):
    conf = os.path.join(
        reference_dir,
        "test/confs_HMC_L04040404_beta5.7_quenched_su3/conf_00000100.ildg.txt",
    )
    u = load_bridge_text(conf, LAT, 3)
    methods = [
        {"methodname": "Plaquette", "measure_every": 1},
        {"methodname": "Polyakov_loop", "measure_every": 2},
        {
            "methodname": "Topological_charge",
            "measure_every": 1,
            "kinds_of_topological_charge": ["plaquette", "clover"],
        },
        {"methodname": "Energy_density", "measure_every": 1},
    ]
    ms = MeasurementSet.from_methods(methods, measuredir=str(tmp_path))
    out1 = ms.calc_measurement_values(1, u)
    out2 = ms.calc_measurement_values(2, u)
    ms.close()
    assert len(out1) == 3  # polyakov skipped at itrj=1
    assert len(out2) == 4
    plaq_lines = open(tmp_path / "Plaquette.txt").read().strip().split("\n")
    assert len(plaq_lines) == 2
    assert plaq_lines[0].endswith("# plaq")
    topo_line = open(tmp_path / "Topological_charge.txt").read().split("\n")[0]
    assert "Qplaq" in topo_line and "Qclover" in topo_line and "Qimproved" in topo_line


def test_pion_correlator_batched_path_matches_sequential(monkeypatch):
    """The accelerator (batched cg_multi) dispatch of cg_multi_auto is
    exercised on the CPU suite via the LQCD_FORCE_SOLVE_MODE hook and
    pinned against the CPU-default sequential path — this is the
    integration-level guarantee that the accelerator solve path
    computes the same measurement (unique lattice shape: the hook is
    read at trace time)."""
    import os

    from latticeqcd_tpu.measurements import fermionic
    from latticeqcd_tpu.ops import fields
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac

    lat = (2, 4, 2, 6)  # deliberately unusual: forces a fresh trace per mode
    u = fields.hot_start(lat, 2, seed=17, dtype=jnp.complex128)
    d = WilsonDirac(kappa=0.12)
    monkeypatch.setenv("LQCD_FORCE_SOLVE_MODE", "sequential")
    c_seq = fermionic.pion_correlator(u, d, eps=1e-20, maxiter=2000)
    monkeypatch.setenv("LQCD_FORCE_SOLVE_MODE", "batched")
    fermionic._solve_dinv_multi.clear_cache()
    c_bat = fermionic.pion_correlator(u, d, eps=1e-20, maxiter=2000)
    fermionic._solve_dinv_multi.clear_cache()
    np.testing.assert_allclose(c_bat, c_seq, rtol=1e-9)


def test_dirac_low_spectrum_staggered_matches_dense():
    """Full-dimension Lanczos (m = dim) is exact: the k lowest Ritz
    values of the packed staggered W on a hot config equal the dense
    eigvalsh lowest k (no degeneracy ambiguity on a disordered
    config)."""
    import jax

    from latticeqcd_tpu.ops.dirac.wilson import apply_boundary_phases

    u = fields.hot_start(LAT, 3, seed=13, dtype=jnp.complex128)
    d = StaggeredDirac(mass=0.3, lattice=LAT)
    up = apply_boundary_phases(u, d.bc)
    ueo = d.packed_links(up)
    half = (LAT[0] // 2,) + LAT[1:] + (3,)
    dim = int(np.prod(half))
    eye = jnp.eye(dim, dtype=u.dtype).reshape((dim,) + half)
    cols = jax.vmap(lambda v: d.apply_w_packed(ueo, v))(eye)
    wmat = np.asarray(cols.reshape(dim, dim)).T
    ev = np.linalg.eigvalsh(0.5 * (wmat + wmat.conj().T))

    k = 4
    vals = fermionic.dirac_low_spectrum(u, d, k=k, m=dim)
    np.testing.assert_allclose(vals, ev[:k], rtol=1e-6, atol=1e-9)
    # Dsl eigenvalues implied by the docstring mapping are real
    assert np.all(vals >= d.mass**2 * 0.999)


def test_dirac_spectrum_measurement_writes_series(tmp_path):
    """Scheduler method 'Dirac_spectrum': k ascending values per line in
    the documented format."""
    u = fields.hot_start(LAT, 3, seed=1, dtype=jnp.complex128)
    methods = [{
        "methodname": "Dirac_spectrum",
        "measure_every": 1,
        "Neig": 3,
        "Nlanczos": 60,
        "fermion_parameters": {"Dirac_operator": "Staggered", "mass": 0.5},
    }]
    ms = MeasurementSet.from_methods(methods, measuredir=str(tmp_path))
    ms.calc_measurement_values(7, u)
    ms.close()
    line = open(tmp_path / "Dirac_spectrum.txt").read().strip()
    assert line.endswith("# dirac low spectrum")
    fieldsv = line.split("#")[0].split()
    assert fieldsv[0] == "7" and len(fieldsv) == 4
    vals = [float(x) for x in fieldsv[1:4]]
    assert vals == sorted(vals)
    assert all(v >= 0.25 * 0.999 for v in vals)  # >= m^2 (PSD W)


def test_dirac_low_spectrum_wilson_and_domainwall_smoke():
    """Non-staggered branches run through D^dag D (Wilson 4D spinors,
    domain-wall 5D fields) and return ascending positive values."""
    from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac

    lat = (4, 4, 2, 2)
    u = fields.hot_start(lat, 3, seed=2, dtype=jnp.complex128)
    for d in (WilsonDirac(kappa=0.12), DomainwallDirac(mass=1.0, m5=-1.0, l5=4)):
        vals = fermionic.dirac_low_spectrum(u, d, k=3, m=40)
        assert len(vals) == 3
        assert list(vals) == sorted(vals)
        assert np.all(vals > 0)
