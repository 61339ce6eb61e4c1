"""Multi-device (8 virtual CPU) sharding tests: SPMD correctness of the
whole compute stack under the 4D lattice decomposition (SURVEY.md 2.5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from latticeqcd_tpu.ops import fields, gauge_action as ga, sun
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction
from latticeqcd_tpu.parallel import make_lattice_mesh, shard_links, default_pes
from latticeqcd_tpu.updates import HMC
from latticeqcd_tpu.updates.heatbath import Heatbath

LAT = (4, 4, 4, 8)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_lattice_mesh((1, 1, 2, 4))


def test_default_pes():
    assert np.prod(default_pes(8)) == 8
    assert default_pes(1) == (1, 1, 1, 1)


def test_sharded_plaquette_matches_single(mesh):
    u = fields.hot_start(LAT, 3, seed=61)
    p_single = float(ga.mean_plaquette(u))
    us = shard_links(u, mesh)
    p_shard = float(jax.jit(ga.mean_plaquette)(us))
    assert abs(p_single - p_shard) < 1e-12


def test_sharded_force_matches_single(mesh):
    u = fields.hot_start(LAT, 3, seed=62)
    act = ga.wilson_gauge_action(3, 5.7)
    f_single = ga.force(act, u)
    us = shard_links(u, mesh)
    f_shard = jax.jit(lambda uu: ga.force(act, uu))(us)
    assert float(jnp.max(jnp.abs(f_single - jnp.asarray(f_shard)))) < 1e-12


def test_sharded_hmc_step_matches_single(mesh):
    """The full jitted HMC trajectory produces bitwise-comparable
    results on 1 device vs the 8-device mesh (same key)."""
    u = fields.hot_start(LAT, 3, seed=63)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=5)
    key = jax.random.PRNGKey(7)
    u1, _, st1 = hmc.step(u, key)
    us = shard_links(u, mesh)
    u2, _, st2 = hmc.step(us, key)
    assert abs(float(st1["dH"]) - float(st2["dH"])) < 1e-8
    assert bool(st1["accepted"]) == bool(st2["accepted"])
    assert float(jnp.max(jnp.abs(u1 - jnp.asarray(u2)))) < 1e-10


def test_sharded_dynamical_hmc_runs(mesh):
    """Dynamical staggered trajectory (CG in the force) end-to-end on the
    mesh — the solver's while_loop and psums must compile SPMD."""
    u = fields.hot_start(LAT, 3, seed=64)
    fa = StaggeredFermiAction(
        StaggeredDirac(mass=0.5, lattice=LAT), nf=4, eps_cg=1e-16, max_cg=500
    )
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=2, fermi_action=fa)
    us = shard_links(u, mesh)
    u2, _, st = hmc.step(us, jax.random.PRNGKey(8))
    assert bool(jnp.isfinite(st["dH"]))
    assert float(sun.unitarity_defect(jnp.asarray(u2))) < 1e-9


def test_sharded_heatbath_matches_single(mesh):
    u = fields.hot_start(LAT, 2, seed=65)
    hb = Heatbath(action=ga.wilson_gauge_action(2, 1.9))
    key = jax.random.PRNGKey(9)
    u1, _ = hb.sweep(u, key)
    us = shard_links(u, mesh)
    u2, _ = hb.sweep(us, key)
    assert float(jnp.max(jnp.abs(u1 - jnp.asarray(u2)))) < 1e-10


# ---------------------------------------------------------------------------
# Multi-host glue (single-process semantics; the cross-host collective
# path is exercised by tests/test_distributed.py)
# ---------------------------------------------------------------------------


def test_multihost_helpers_single_process(mesh):
    from latticeqcd_tpu.parallel import (
        get_myrank,
        get_nprocs,
        initialize_multihost,
        is_rank0,
        to_host_global,
    )

    # no coordinator -> stays single-process, no raise
    initialize_multihost()
    assert get_nprocs() == 1
    assert get_myrank() == 0
    assert is_rank0()

    u = fields.hot_start(LAT, 2, seed=63)
    us = shard_links(u, mesh)
    # fully-addressable sharded array round-trips through the gather
    np.testing.assert_array_equal(to_host_global(us), np.asarray(u))


def test_multirun_cli_parses_and_runs(tmp_path):
    """multirun end-to-end on the virtual mesh (mpirun.jl analog)."""
    import sys

    from latticeqcd_tpu import multirun

    toml = tmp_path / "quick.toml"
    toml.write_text(
        """
[Physical_setting]
L = [4, 4, 4, 4]
NC = 2
beta = 1.9
update_method = "HMC"
quench = true
Nsteps = 2
Nthermalization = 0
randomseed = 111
initial = "hot"

[System_Control]
verboselevel = 1
logfile = ""

[HMC_related]
MDsteps = 4
dtau = 0.25
"""
    )
    rc = multirun.main([str(toml), "1", "1", "2", "4", "--cpu"])
    assert rc == 0
