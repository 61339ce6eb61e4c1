"""External physics anchor: Nf=4 staggered chiral condensate vs beta
against the digitized reference curve from inspirehep 283285 (MT(c)
collaboration, 8 x 12^3, ma=0.025), embedded in the reference at
/root/reference/src/examples/reproductions/parameters_staggered_HMC.jl:78-90.

Runs own HMC chains at 2-3 beta points on the SAME lattice/mass and
compares <pbp> (Wolff tau_int errors) to the digitized values. A CPU
run (--cpu, complex128) takes hours per point; without --cpu it runs
on the GPU in complex64. Append results to VALIDATION.md via --emit.

Usage: python scripts/validation_pbp_beta.py [beta ...] [--traj N]
Prints one JSON line per beta point.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

from latticeqcd_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from latticeqcd_tpu.analysis import autocorrelation  # noqa: E402
from latticeqcd_tpu.measurements import fermionic  # noqa: E402
from latticeqcd_tpu.ops import fields, gauge_action as ga  # noqa: E402
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac  # noqa: E402
from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction  # noqa: E402
from latticeqcd_tpu.updates import HMC  # noqa: E402

# Digitized reference points (plot-digitizer output shipped inside the
# reference's example file; fig 2b of 10.1016/0370-2693(89)90447-4)
REFERENCE_CURVE = {
    5.100: 0.662943264422041,
    5.175: 0.3819303478073508,
    5.200: 0.2874088522470827,
    5.250: 0.24762703983851386,
    5.300: 0.2109864936891166,
    5.400: 0.1686361007473265,
    5.600: 0.13783581497147912,
}
LAT = (12, 12, 12, 8)
MASS = 0.025
NF = 4
if os.environ.get("LQCD_PBP_SMOKE"):  # tiny-shape harness smoke test
    LAT = (4, 4, 4, 4)
    MASS = 0.5


CAPDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "PERF_CAPTURE")


def _ckpt_path(beta):
    return os.path.join(CAPDIR, f"pbp{beta:g}".replace(".", "") + "_ckpt.npz")


def _series_path(beta):
    return os.path.join(CAPDIR, f"pbp{beta:g}".replace(".", "") + "_series.jsonl")


def run_point(beta: float, n_therm: int, n_meas: int, measure_every: int = 2,
              dtype=jnp.complex64, seed: int = 11):
    """One beta point: HMC chain + stochastic pbp series -> (mean, err).

    Long CPU runs survive interruption: the chain state is checkpointed
    every 10 trajectories (pbpB_ckpt.npz) and every measurement is
    appended to pbpB_series.jsonl as it lands, so a partial run still
    yields a usable (mean, err) from the committed series.
    """
    # MD parameters follow the reference example's commented ladder
    # (35 steps of 1/35 near beta 5.3-5.4); cold start off the broken
    # phase as the paper did for beta >= 5.175
    md_steps = 4 if os.environ.get("LQCD_PBP_SMOKE") else 35
    dirac = StaggeredDirac(mass=MASS, lattice=LAT)
    fa = StaggeredFermiAction(dirac, nf=NF, eps_cg=1e-10, max_cg=4000)
    hmc = HMC(action=ga.wilson_gauge_action(3, beta), dtau=1.0 / md_steps,
              md_steps=md_steps, fermi_action=fa)
    u = fields.cold_start(LAT, 3, dtype=dtype)
    key = jax.random.PRNGKey(seed)
    mkey = jax.random.PRNGKey(seed + 999)
    i0, n_acc, series = 0, 0, []
    ckpt = _ckpt_path(beta)
    if os.path.exists(ckpt) and not os.environ.get("LQCD_PBP_SMOKE"):
        d = np.load(ckpt)
        u = jnp.asarray(d["u"]).astype(dtype)
        key = jnp.asarray(d["key"])
        mkey = jnp.asarray(d["mkey"])
        i0, n_acc = int(d["i"]), int(d["n_acc"])
        series = list(d["series"])
        print(f"# beta={beta} resumed at traj {i0} ({len(series)} meas)",
              flush=True)
    t0 = time.time()
    for i in range(i0, n_therm + n_meas):
        u, key, st = hmc.step(u, key)
        in_therm = i < n_therm
        if in_therm and i % 10 == 0:
            print(f"# beta={beta} therm {i}/{n_therm} plaq={float(st['plaq']):.5f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        if in_therm and i == 12 and float(st["plaq"]) > 0.9999:
            # a chain that never moves off the cold start (plaq pinned
            # at ~1.0 — not exactly 1.0 in c64, which is why this is a
            # threshold; a healthy chain at beta<=5.6 is far below 0.99
            # after 12 trajectories) is broken: abort with nonzero exit
            print(f"# FROZEN chain (plaq~1.0 after {i} traj); aborting", flush=True)
            sys.exit(1)
        if not in_therm:
            n_acc += int(st["accepted"])
            if (i - n_therm) % measure_every == 0:
                mkey, sub = jax.random.split(mkey)
                pbp, _ = fermionic.chiral_condensate(
                    u, dirac, sub, nr=2, nf_factor=NF / 4.0, eps=1e-9, maxiter=4000
                )
                series.append(float(pbp))
                if not os.environ.get("LQCD_PBP_SMOKE"):
                    with open(_series_path(beta), "a") as fp:
                        fp.write(json.dumps({
                            "traj": i, "pbp": float(pbp),
                            "plaq": float(st["plaq"]),
                            "wall_s": round(time.time() - t0, 1)}) + "\n")
                if len(series) % 10 == 1:
                    print(f"# beta={beta} meas {i - n_therm}/{n_meas} pbp={pbp:.4f} "
                          f"({time.time()-t0:.0f}s)", flush=True)
        if (i + 1) % 10 == 0 and not os.environ.get("LQCD_PBP_SMOKE"):
            np.savez(ckpt, u=np.asarray(u), key=np.asarray(key),
                     mkey=np.asarray(mkey), i=i + 1, n_acc=n_acc,
                     series=np.asarray(series))
    mean, err, tau, w = autocorrelation(np.asarray(series))
    return {
        "beta": beta, "pbp": round(mean, 5), "err": round(err, 5),
        "tau_int": round(tau, 2), "n_meas": len(series),
        "acceptance": round(n_acc / max(n_meas, 1), 3),
        "reference": REFERENCE_CURVE.get(beta),
        "lattice": "x".join(str(x) for x in LAT), "mass": MASS, "nf": NF,
        "wall_s": round(time.time() - t0, 1),
        "device": str(jax.devices()[0]),
    }


if __name__ == "__main__":
    argv = list(sys.argv[1:])
    n_traj = 260
    if "--traj" in argv:
        i = argv.index("--traj")
        n_traj = int(argv[i + 1])
        del argv[i:i + 2]
    betas = [float(a) for a in argv if not a.startswith("--")] or [5.6, 5.3]
    n_therm = min(max(4, n_traj // 4), max(n_traj - 4, 1))
    for beta in betas:
        out = run_point(beta, n_therm=n_therm, n_meas=n_traj - n_therm)
        print(json.dumps(out), flush=True)
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                               "PERF_CAPTURE", "pbp_beta.jsonl"), "a") as fp:
            fp.write(json.dumps(out) + "\n")
