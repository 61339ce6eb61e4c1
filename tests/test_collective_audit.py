"""Static communication audit of the sharded SPMD programs (VERDICT r2
next-round #9): lower the hot programs to optimized HLO on the 8-device
virtual mesh and pin the collective inventory.

What the pins guarantee (the multi-chip design claims, docs/design.md
"SPMD parallelism"):

* D-slash: halo exchange ONLY — 3 collective-permutes per sharded axis
  (psi forward, psi backward, links backward), nothing else. No
  all-gather: the stencil never materializes a neighbor's full shard.
* CG: the two D-slashes' permutes + SCALAR all-reduces for the inner
  products. Round-3 finding fixed here: jnp.vdot ravels its operands,
  which made GSPMD all-gather the FULL field on every iteration; the
  elementwise sum(conj(a)*b) form removes every all-gather from the
  solver hot loop (ops/solvers.py _vdot, ops/dirac/wilson.py inner).
* Full HMC trajectory: collective-permutes scale with MD steps (halo
  exchanges in force/action staples), all-reduces are scalar-only
  (energies/plaquette), and there is NO all-gather and NO all-to-all
  anywhere in the compiled program.
"""

import re
from collections import Counter

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from latticeqcd_tpu.ops import fields, gauge_action as ga, solvers
from latticeqcd_tpu.ops.dirac.wilson import (
    WilsonDirac,
    apply_boundary_phases,
    gaussian_spinor,
)
from latticeqcd_tpu.parallel import make_lattice_mesh, shard_links
from latticeqcd_tpu.updates import HMC

LAT = (4, 4, 8, 8)
PES = (1, 1, 2, 4)  # 2 sharded axes
N_SHARDED_AXES = 2

_COLLECTIVE = re.compile(
    r"= (?P<shape>\S+|\([^)]*\)) (?P<op>collective-permute|all-reduce|all-gather"
    r"|all-to-all|reduce-scatter)(?:-start)?\("
)


def _audit(hlo: str):
    """-> (Counter of op kinds, non-scalar REDUCTION lines, permute lines).

    collective-permutes legitimately carry halo planes (non-scalar by
    design); all-reduce/all-gather results in these programs must be
    scalars (energies, inner products) — a field-shaped one means the
    partitioner started shipping whole shards."""
    ops = Counter()
    nonscalar_reduce = []
    permutes = []
    for line in hlo.splitlines():
        m = _COLLECTIVE.search(line)
        if not m:
            continue
        ops[m.group("op")] += 1
        shapes = re.findall(r"[a-z]\d+\[([\d,]*)\]", m.group("shape"))
        if m.group("op") == "collective-permute":
            permutes.append((shapes, line.strip()))
        elif any(s for s in shapes):
            nonscalar_reduce.append(line.strip())
    return ops, nonscalar_reduce, permutes


def _assert_permutes_are_halo_planes(permutes):
    """Every halo exchange moves a boundary PLANE (some lattice dim of
    extent 1), never a full shard."""
    for shapes, line in permutes:
        for s in shapes:
            dims = [int(x) for x in s.split(",") if x]
            assert 1 in dims, line


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_lattice_mesh(PES)


@pytest.fixture(scope="module")
def sharded_fields(mesh):
    u = apply_boundary_phases(fields.hot_start(LAT, 3, seed=0))
    psi = gaussian_spinor(jax.random.PRNGKey(1), LAT, 3, nspin=4)
    us = shard_links(u, mesh)
    ps = jax.device_put(psi, NamedSharding(mesh, P("x", "y", "z", "t", None, None)))
    return us, ps


def test_dslash_halo_exchange_is_minimal(sharded_fields):
    us, ps = sharded_fields
    d = WilsonDirac(kappa=0.141139)
    hlo = jax.jit(d.apply).lower(us, ps).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert nonscalar == []
    # 3 halo permutes per sharded axis: psi(x+mu), psi(x-mu), U(x-mu)
    assert ops["collective-permute"] == 3 * N_SHARDED_AXES, ops
    assert ops["all-gather"] == 0, ops
    assert ops["all-reduce"] == 0, ops
    assert ops["all-to-all"] == 0, ops


def test_cg_hot_loop_has_no_all_gather(sharded_fields):
    us, ps = sharded_fields
    d = WilsonDirac(kappa=0.141139)
    f = jax.jit(
        lambda uu, bb: solvers.cg(
            lambda v: d.apply_ddag_d(uu, v), bb, eps=1e-10, maxiter=50
        )[0]
    )
    hlo = f.lower(us, ps).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    # DdagD = 2 D-slashes -> 12 permutes; inner products -> scalar
    # all-reduces only (measured 4: rsq, target, p.Ap grouped by XLA)
    assert ops["collective-permute"] == 2 * 3 * N_SHARDED_AXES, ops
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert 1 <= ops["all-reduce"] <= 8, ops
    assert nonscalar == [], nonscalar[:3]


def test_full_hmc_trajectory_collectives(sharded_fields):
    us, _ = sharded_fields
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=5)
    hlo = jax.jit(hmc._step_fused).lower(us, jax.random.PRNGKey(0)).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    # every all-reduce in the trajectory is a scalar energy/plaquette sum
    assert nonscalar == [], nonscalar[:3]
    # halo permutes: measured 48 for 5 QPQ steps (force staples + action
    # evaluations); pin a band so a layout regression (e.g. an op that
    # starts gathering instead of exchanging halos) is caught without
    # tying the test to one XLA version's exact fusion choices
    assert 0 < ops["collective-permute"] <= 12 * (5 + 2), ops


def test_collective_inventory_documented(sharded_fields):
    """The docs/design.md table must quote the measured counts."""
    with open("docs/design.md") as fp:
        text = fp.read()
    assert "collective inventory" in text.lower()


def test_staggered_packed_w_cg_collectives(mesh):
    """The RHMC hot operator (VERDICT r3 weak #7): CG on the PACKED
    even-odd staggered normal operator W = m^2 - D_eo D_oe. Each packed
    dslash needs 3 halo permutes per sharded axis (psi +mu, psi -mu,
    links -mu — same stencil inventory as Wilson, eo_pack.py gathers);
    W = 2 dslashes -> 12 permutes on the 2-axis mesh, scalar-only
    all-reduces from the CG inner products, and no all-gather."""
    from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac

    d = StaggeredDirac(mass=0.1, lattice=LAT)
    u = apply_boundary_phases(fields.hot_start(LAT, 3, seed=3))
    u_e, u_o = d.packed_links(u)
    b = d.pack(gaussian_spinor(jax.random.PRNGKey(4), LAT, 3, nspin=1), 0)
    link_spec = NamedSharding(mesh, P(None, "x", "y", "z", "t", None, None))
    field_spec = NamedSharding(mesh, P("x", "y", "z", "t", None))
    u_es = jax.device_put(u_e, link_spec)
    u_os = jax.device_put(u_o, link_spec)
    bs = jax.device_put(b, field_spec)

    f = jax.jit(
        lambda ue, uo, bb: solvers.cg(
            lambda v: d.apply_w_packed((ue, uo), v), bb, eps=1e-10, maxiter=50
        )[0]
    )
    hlo = f.lower(u_es, u_os, bs).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert ops["collective-permute"] == 2 * 3 * N_SHARDED_AXES, ops
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert 1 <= ops["all-reduce"] <= 8, ops
    assert nonscalar == [], nonscalar[:3]


def test_flowed_measurement_collectives(mesh):
    """Gradient-flow + measurement program (VERDICT r3 weak #7): Nflow
    RK3 steps (force staples = halo exchanges) followed by plaquette +
    energy-density measurement must stay all-gather-free with
    scalar-only all-reduces."""
    from latticeqcd_tpu.measurements.observables import energy_density
    from latticeqcd_tpu.smearing.gradientflow import gradientflow

    u = apply_boundary_phases(fields.hot_start(LAT, 3, seed=5))
    us = shard_links(u, mesh)
    gf = gradientflow(3, nflow=2, eps=0.01)

    def prog(uu):
        uf = gf.flow(uu)
        return ga.mean_plaquette(uf), energy_density(uf)

    hlo = jax.jit(prog).lower(us).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert nonscalar == [], nonscalar[:3]
    # RK3 scan body: 3 generic-action force evaluations (6 staples per
    # direction, each needing link-halo rolls) + the clover-leaf energy
    # density = 156 permutes measured (2026-08-21, 2 sharded axes);
    # every one verified above to carry a boundary plane. Band allows
    # XLA fusion drift but catches a layout regression that would
    # multiply halo traffic or start gathering shards.
    assert 0 < ops["collective-permute"] <= 200, ops


def test_chain_sharded_ensemble_dp_has_zero_collectives():
    """Ensemble data parallelism: step_batched with the CHAIN axis
    sharded over all devices (one independent Markov chain per device)
    must compile to ZERO collectives of any kind — chains never
    communicate, so ensemble throughput scales linearly over devices
    with no traffic at all (the third scaling axis next to 4D domain
    decomposition and even-odd; measured 2026-08-21: empty collective
    inventory, 8 chains / 8 virtual devices)."""
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    chain_mesh = Mesh(jax.devices()[:8], ("chain",))
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=3,
              staged=False)
    us = jnp.stack([fields.hot_start((4, 4, 4, 4), 3, seed=s) for s in range(8)])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(8))
    us_s = jax.device_put(us, NamedSharding(chain_mesh, P("chain")))
    keys_s = jax.device_put(keys, NamedSharding(chain_mesh, P("chain")))
    f = jax.jit(lambda u, k: jax.vmap(hmc._step_fused)(u, k))
    hlo = f.lower(us_s, keys_s).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    assert sum(ops.values()) == 0, ops
    _, _, st = f(us_s, keys_s)
    assert st["dH"].shape == (8,)


def test_domainwall_schur_cg_collectives(mesh):
    """Round-4 DW packed Schur operator: Shat = A - B_eo A^-1 B_oe with
    A site-local (L5 couplings never shard) and B the Wilson hop — so
    one Shat apply costs the same halo inventory as the staggered
    packed W: 3 permutes per sharded axis per hop x 2 hops = 12 on the
    2-axis mesh; the L5 axis contributes ZERO collectives. CGNE adds
    scalar all-reduces only."""
    from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac

    d = DomainwallDirac(mass=0.3, m5=-1.0, l5=4)
    u = apply_boundary_phases(fields.hot_start(LAT, 3, seed=6))
    u_e, u_o = d.packed_links(u)
    psi = gaussian_spinor(jax.random.PRNGKey(7), LAT, 3, nspin=4)
    b = d.pack5(jnp.broadcast_to(psi, (4,) + psi.shape), LAT, 0)
    link_spec = NamedSharding(mesh, P(None, "x", "y", "z", "t", None, None))
    field_spec = NamedSharding(mesh, P(None, "x", "y", "z", "t", None, None))
    u_es = jax.device_put(u_e, link_spec)
    u_os = jax.device_put(u_o, link_spec)
    bs = jax.device_put(b, field_spec)

    f = jax.jit(
        lambda ue, uo, bb: solvers.cg(
            lambda v: d.apply_schur_ddag_d((ue, uo), v), bb,
            eps=1e-10, maxiter=30,
        )[0]
    )
    hlo = f.lower(u_es, u_os, bs).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    # Shat^dag Shat = 2 Shat applies = 4 hops; the naive count is
    # 4*3*N_SHARDED_AXES = 24, but the transposed (dagger) apply's
    # link gathers don't always CSE with the forward ones (measured
    # 38, 2026-08-21) — pin a band plus the invariants that matter:
    # every permute is a 4D halo plane (so the L5 axis contributes
    # ZERO collectives) and nothing gathers a full shard.
    assert 4 * 3 * N_SHARDED_AXES <= ops["collective-permute"] <= 48, ops
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert nonscalar == [], nonscalar[:3]


def test_fermion_force_grad_has_no_plane_allreduces(mesh, sharded_fields):
    """Round-4 rolls.roll primitive: jax.grad of the fermion force used
    to transpose jnp.roll into pad ops that GSPMD partitioned as
    halo-plane ALL-REDUCES (measured: 93 permutes + 4 plane-shaped
    all-reduces per sharded Wilson force). With the custom primitive
    (transpose-of-roll = opposite roll) the same program measures 68
    permutes and scalar-only all-reduces. Pin the invariants."""
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction

    us, ps = sharded_fields
    fa = WilsonFermiAction(WilsonDirac(kappa=0.12), eps_cg=1e-10, max_cg=40)
    f = jax.jit(lambda uu, pp: fa.force(uu, pp))
    hlo = f.lower(us, ps).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert nonscalar == [], nonscalar[:3]
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert 0 < ops["collective-permute"] <= 80, ops


def test_stout_smeared_force_grad_collectives(mesh, sharded_fields):
    """The autodiff chain through the stout stack (replacing the
    reference's hand-written back_prop) must also stay free of
    plane-shaped all-reduces: measured 176 halo permutes (staple
    exchanges through the smear chain rule), scalar-only all-reduces,
    zero all-gathers (2026-08-21, after the rolls.roll primitive)."""
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction
    from latticeqcd_tpu.smearing.stout import stout_stack

    us, ps = sharded_fields
    net = stout_stack((0.1,))
    fa = WilsonFermiAction(WilsonDirac(kappa=0.12), eps_cg=1e-10, max_cg=30)
    f = jax.jit(lambda uu, pp: fa.force(uu, pp, smear_fn=net.smear))
    hlo = f.lower(us, ps).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert nonscalar == [], nonscalar[:3]
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert 0 < ops["collective-permute"] <= 220, ops


def test_rhmc_multishift_force_collectives(mesh):
    """The dynamical-staggered RHMC hot path end to end: rational
    coefficients + multi-shift CG on the packed W + per-shift force
    accumulation + grad through the packed stencils. Measured
    2026-08-21: 372 halo-plane permutes, scalar-only all-reduces, zero
    all-gathers (the multi-shift recurrence adds only scalar
    zeta/alpha algebra, never field-shaped collectives)."""
    from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction

    u = fields.hot_start(LAT, 3, seed=0)
    us = shard_links(u, mesh)
    fa = StaggeredFermiAction(StaggeredDirac(mass=0.5, lattice=LAT), nf=2,
                              eps_cg=1e-10, max_cg=40)
    _, phi = fa.sample_pseudofermion(u, jax.random.PRNGKey(1))
    phis = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(
            mesh, P(*([None] * (a.ndim - 5)), "x", "y", "z", "t", None))),
        phi,
    )
    f = jax.jit(lambda uu, pp: fa.force(uu, pp))
    hlo = f.lower(us, phis).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert nonscalar == [], nonscalar[:3]
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert 0 < ops["collective-permute"] <= 450, ops


def test_mixed_md_trajectory_collectives(sharded_fields):
    """md_precision='mixed' (f64 real-pair MD state, ops/mdpair.py)
    must keep the plain path's collective discipline: the PairField
    re/im leaves carry the links' 4D sharding, so halo exchanges stay
    collective-permutes of planes and the only all-reduces are scalar
    energies. A pathological GSPMD outcome (the pair representation
    tricking the partitioner into gathering shards) would show here."""
    us, _ = sharded_fields
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=5,
              md_precision="mixed")
    hlo = jax.jit(hmc._step_fused).lower(us, jax.random.PRNGKey(0)).compile().as_text()
    ops, nonscalar, permutes = _audit(hlo)
    _assert_permutes_are_halo_planes(permutes)
    assert ops["all-gather"] == 0, ops
    assert ops["all-to-all"] == 0, ops
    assert nonscalar == [], nonscalar[:3]
    assert 0 < ops["collective-permute"] <= 12 * (5 + 2), ops
