"""chip_smoke.py on the CPU: its comparison routines, its refusal to
run without a GPU, its TOML, and its phase selection. The GPU run
itself is `python chip_smoke.py` on the card."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_operator_compare_cpu_against_cpu(smoke):
    """Phase 1's routine at 4^4 with two CPU devices standing in for the
    GPU and the reference: every operator agrees in both dtypes."""
    cpu = jax.devices("cpu")
    cases = smoke.operator_cases((4, 4, 4, 4), (4, 4, 4, 4), 4)
    results = smoke.phase1_operators(cpu[1], cpu[0], cases)
    assert len(results) == 2 * len(cases) == 12
    assert all(r["ok"] and r["max_abs"] == 0.0 for r in results)


@pytest.mark.parametrize("dtype,size", [(jnp.complex64, 1e-3), (jnp.complex128, 1e-9)])
def test_compare_flags_injected_perturbation(smoke, dtype, size):
    """A relative perturbation of the size TF32 rounding would leave
    (1e-3) fails the complex64 check; one far above double rounding
    fails the complex128 check. The unperturbed output passes."""
    rng = np.random.default_rng(0)
    ref = (rng.normal(size=(4, 4, 3)) + 1j * rng.normal(size=(4, 4, 3))).astype(dtype)
    assert smoke.compare(ref.copy(), ref, dtype)["ok"]
    got = ref.copy()
    got[1, 2, 0] += size * np.max(np.abs(ref))
    r = smoke.compare(got, ref, dtype)
    assert not r["ok"]
    assert r["rel"] == pytest.approx(size, rel=1e-3)


def test_trajectory_compare_cpu_against_cpu(smoke):
    """Phase 2's routine at 4^4 on two CPU devices: same accept, dH and
    plaquette in both dtypes."""
    cpu = jax.devices("cpu")
    out = smoke.phase2_trajectory(cpu[1], cpu[0], lattice=(4, 4, 4, 4))
    for got, ref in out.values():
        assert got["accepted"] == ref["accepted"]
        assert got["dH"] == ref["dH"] and got["plaq"] == ref["plaq"]


def test_recording_solves_reports_each_solve(smoke):
    """Each CG solve run inside a compiled program while recording
    reports its iterations and true residual; solvers.cg is restored on
    exit."""
    from latticeqcd_tpu.ops import solvers

    plain_cg = solvers.cg
    rng = np.random.default_rng(1)
    m = rng.normal(size=(12, 12))
    a = jnp.asarray(m @ m.T + 12 * np.eye(12), dtype=jnp.complex128)
    b = jnp.asarray(rng.normal(size=12), dtype=jnp.complex128)
    with smoke.recording_solves() as solves:
        x = jax.jit(lambda bb: solvers.cg(lambda v: a @ v, bb, eps=1e-24)[0])(b)
        x.block_until_ready()
        jax.effects_barrier()
    assert solvers.cg is plain_cg
    assert len(solves) == 1
    sv = solves[0]
    assert 0 < sv["iters"] < sv["max_cg"] and sv["target"] == 1e-24
    r = np.asarray(b - a @ x)
    assert sv["true_rel_r2"] == pytest.approx(np.vdot(r, r).real / np.vdot(b, b).real, rel=1e-6)
    assert sv["true_rel_r2"] <= sv["target"]


@pytest.fixture
def cold_toml(smoke, monkeypatch):
    """write_toml with a cold start: at a tiny volume a hot start's
    plaquette is as often below 0 as above."""
    plain = smoke.write_toml

    def write_toml(path, *args, **kwargs):
        plain(path, *args, **kwargs)
        with open(path) as f:
            text = f.read().replace('initial = "hot"', 'initial = "cold"')
        with open(path, "w") as f:
            f.write(text)
        return path

    monkeypatch.setattr(smoke, "write_toml", write_toml)


def test_main_path_and_staged_vs_fused_on_cpu(smoke, cold_toml, tmp_path):
    """Phases 3 and 4 at 4^3x8 on the CPU: the driver in both precisions
    with every trajectory's solves recorded, then staged against fused."""
    clock = smoke.CompileClock()
    out, toml = smoke.phase3_main_path(str(tmp_path), clock, lattice=(4, 4, 4, 8),
                                       extra_args=("--cpu",))
    for recs in out.values():
        assert len(recs) == smoke.NTRAJ
        assert all(len(r["solves"]) == smoke.MDSTEPS + 1 for r in recs)
    res = smoke.phase4_staged_vs_fused(toml, clock)
    assert res["staged"]["accepted"] == res["fused"]["accepted"]


def test_four_cards_compare_on_cpu_mesh(smoke, tmp_path):
    """The sharded phase on four CPU devices at 4^3x8: both meshes agree
    with the one-device run."""
    runs = smoke.phase_four_cards(str(tmp_path), lattice=(4, 4, 4, 8),
                                  devices=jax.devices()[:4])
    assert set(runs) == {"pes1114", "pes1122"}


@pytest.mark.parametrize("dtype,size,expected", [
    (jnp.complex128, 1e5, 1e-8),       # 16 ulps of 1e5 < 1e-8
    (jnp.complex128, 1e8, 16 * 2.0 ** -52 * 1e8),
    (jnp.complex64, 1e5, 16 * 2.0 ** -23 * 1e5),
])
def test_dh_tolerance(smoke, dtype, size, expected):
    a = {"action_size": size}
    b = {"action_size": size / 2}
    assert smoke.dh_tol(dtype, a, b) == pytest.approx(expected)


def test_exits_nonzero_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def test_toml_parses_and_builds_universe(smoke, tmp_path, monkeypatch):
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction
    from latticeqcd_tpu.system.params import construct_params_from_toml
    from latticeqcd_tpu.system.universe import build_universe
    from latticeqcd_tpu.updates.factory import updatemethod

    monkeypatch.chdir(tmp_path)
    toml = smoke.write_toml(str(tmp_path / "s.toml"), "s", lattice=(4, 4, 4, 4))
    p = construct_params_from_toml(toml, make_dirs=False)
    assert p.L == (4, 4, 4, 4) and p.beta == smoke.BETA and p.hop == smoke.KAPPA
    assert p.initial == "hot" and p.Nsteps == smoke.NTRAJ and not p.quench
    assert [m["methodname"] for m in p.measurement_methods] == [
        "Plaquette", "Polyakov_loop", "Chiral_condensate"]
    univ = build_universe(p)
    assert isinstance(univ.fermi_action, WilsonFermiAction)
    assert univ.fermi_action.dirac.kappa == smoke.KAPPA
    assert univ.u.shape == (4, 4, 4, 4, 4, 3, 3)
    hmc = updatemethod(p, univ)
    assert (hmc.dtau, hmc.md_steps) == (smoke.DTAU, smoke.MDSTEPS)
    univ.verbose_print.close()


def test_four_cards_selects_only_the_sharded_phase(smoke):
    assert smoke.plan(["--four-cards"]) == ["device", "four_cards"]
    default = smoke.plan([])
    assert default[0] == "device" and "four_cards" not in default
    assert default[1:] == ["operators", "trajectory", "main_path",
                           "staged_vs_fused", "kernels"]
