"""Smoke test of the lattice QCD engine on NVIDIA GPUs.

    python chip_smoke.py               # phases 0-5 on one GPU
    python chip_smoke.py --four-cards  # phase 0, then the sharded driver on four GPUs

Run it from the root of a checkout. Everything runs in this one
process, which holds the card from start to end and starts no child
that would open it a second time (``nvidia-smi`` is the only child).

Phase 0  The device. Refuses, with a non-zero exit and no result line,
         unless JAX's first device is a GPU.
Phase 1  Each operator of the HMC path at 32^3x64 (domain wall at
         16^3x32, L5=16), applied on the GPU and on the CPU of this
         process to the same host-made inputs, in complex128 and
         complex64.
Phase 2  One whole 2-flavour Wilson HMC trajectory at 8^4 on the GPU and
         on the CPU, same links and key.
Phase 3  The TOML driver, ``latticeqcd_tpu.run.main``, at 32^3x64:
         three trajectories in complex64 (``--f32``) and in complex128,
         each CG solve of each trajectory checked from inside its
         compiled program.
Phase 4  The staged (many-program) against the fused (one-program) HMC
         trajectory at the Phase 3 volume and key, complex64: the same
         accept decision, links and action terms.
Phase 5  Median time of the Wilson D-slash and the packed staggered W at
         32^3x64, complex64 and complex128.
--four-cards  The Phase 3 TOML in complex128 through ``run_lqcd_file``
         sharded over PEs (1,1,1,4) and (1,1,2,2), then on one card,
         and each sharded run against the one-card run.

No phase catches its own failure: any failed check ends the run with a
traceback and a non-zero exit code. The last line of standard output
is one JSON object, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from latticeqcd_tpu.ops import fields, gauge_action as ga, solvers, sun
from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac, apply_boundary_phases, gaussian_spinor
from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction
from latticeqcd_tpu.updates import HMC
from latticeqcd_tpu.utils.compile_cache import configure_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(REPO, ".smoke_run")

LATTICE = (32, 32, 32, 64)
DW_LATTICE = (16, 16, 16, 32)
DW_L5 = 16
TRAJ_LATTICE = (8, 8, 8, 8)

BETA = 6.0
KAPPA = 0.13
# |dH| grows as V * dtau^4: at 8^4 from a hot start, dtau = 0.007 with
# 5 steps gives |dH| ~ 3e-3 (CPU, complex128), so ~1 at 32^3x64.
DTAU = 0.007
MDSTEPS = 5
NTRAJ = 3

# Relative to max|ref|. complex128 differs from the CPU only in the
# order of sums; complex64 is float32 rounding over a few hundred
# operations. A float32 product run in TF32 would show ~1e-3.
REL_TOL = {"complex128": 1e-12, "complex64": 1e-5}
# complex128 trajectories, device against CPU or sharded against one card
DH_TOL_C128 = 1e-8
PLAQ_TOL_C128 = 1e-12
PLAQ_TOL_SHARDED = 1e-10
# dH is a difference of O(V) sums (kinetic, gauge and pseudofermion,
# before and after), each rounded in its own order on each device or
# mesh; 16 ulps of the dtype at their summed size bounds the difference.
# In complex128 one such ulp is 2e-8 at 32^3x64, so there the fixed
# DH_TOL_C128 gives way to the ulp bound.
DH_ULPS = 16
# Staged against fused, complex64: each returned quantity (links,
# plaquette, and the proposal's action terms) within float32 rounding.
STAGED_REL_TOL = 1e-5
PROPOSAL_TERMS = ("sg_new", "sp_new", "sf_new")
# A solve stops on its recursive |r|^2; the true |b - A x|^2 of the x it
# returns may sit a little above that in rounding.
SOLVE_SLACK = 2.0

# bytes an operator must move at least, per site of its output lattice,
# in units of one complex number: Wilson D reads a 12-component spinor
# and four 3x3 links and writes a spinor (24 + 36 = 60 complex = 480 B
# in complex64). The packed staggered W = m^2 - D_eo D_oe makes two
# half-volume hops, each reading all 4V links and V/2 3-vectors and
# writing V/2 3-vectors: 2 * (36 + 3) complex per (full-lattice) site.
WILSON_COMPLEX_PER_SITE = 60
STAGGERED_W_COMPLEX_PER_SITE = 2 * (36 + 3)


def log(*vals) -> None:
    print(*vals, flush=True)


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its own
    monitoring events (persistent-cache hits record no backend compile)."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


# ------------------------------------------------------------------ phase 0


def gpu_name_and_power() -> list:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


def phase0_device(cache_dir: str):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's first device is {dev.platform!r}, not a GPU")
    log(f"phase0 device_kind={dev.device_kind!r} count={len(jax.devices())} "
        f"jax={jax.__version__} compile_cache={cache_dir}")
    for i, line in enumerate(gpu_name_and_power()):
        log(f"phase0 nvidia-smi[{i}]: {line}")
    return dev


# ------------------------------------------------------------------ phase 1


def compare(got, ref, dtype) -> dict:
    """Max abs error, error relative to max|ref|, and the dtype's tolerance."""
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))
    rel = err / float(np.max(np.abs(ref)))
    tol = REL_TOL[jnp.dtype(dtype).name]
    return {"max_abs": err, "rel": rel, "tol": tol, "ok": bool(rel <= tol)}


def run_on(fn, host_args, device):
    args = [jax.device_put(a, device) for a in host_args]
    return np.asarray(jax.jit(fn)(*args))


def operator_cases(lattice=LATTICE, dw_lattice=DW_LATTICE, l5=DW_L5, seed=0):
    """[(name, fn, host_args)] in complex128; inputs made on the host."""
    cpu = jax.devices("cpu")[0]
    half = (lattice[0] // 2,) + tuple(lattice[1:])
    dw_half = (l5, dw_lattice[0] // 2) + tuple(dw_lattice[1:])
    keys = jax.random.split(jax.random.PRNGKey(seed), 5)
    wd = WilsonDirac(kappa=KAPPA)
    sd = StaggeredDirac(mass=0.1, lattice=tuple(lattice))
    dd = DomainwallDirac(mass=0.1, m5=-1.0, l5=l5)
    action = ga.wilson_gauge_action(3, BETA)
    with jax.default_device(cpu):
        u = fields.hot_start(lattice, 3, seed=seed)
        up = apply_boundary_phases(u)
        u_dw = apply_boundary_phases(fields.hot_start(dw_lattice, 3, seed=seed + 1))
        psi = gaussian_spinor(keys[0], lattice, 3)
        x_e = gaussian_spinor(keys[1], half, 3)
        chi_e = gaussian_spinor(keys[2], half, 3, nspin=1)
        phi_dw = gaussian_spinor(keys[3], dw_half, 3)
        h = sun.random_hermitian_momentum(keys[4], (4,) + tuple(lattice), 3)
    host = lambda *xs: tuple(np.asarray(x) for x in xs)  # noqa: E731
    return [
        ("wilson_D", wd.apply, host(up, psi)),
        ("wilson_eo_schur_normal",
         lambda uu, x: wd.apply_dhat_ddag(wd.packed_links(uu), x), host(up, x_e)),
        ("staggered_W_packed",
         lambda uu, x: sd.apply_w_packed(sd.packed_links(uu), x), host(up, chi_e)),
        ("domainwall_schur_normal",
         lambda uu, x: dd.apply_schur_ddag_d(dd.packed_links(uu), x), host(u_dw, phi_dw)),
        ("gauge_force_plaquette", partial(ga.force, action), host(u)),
        ("sun_expi_hermitian", lambda hh: sun.expi_hermitian(hh, 0.1), host(h)),
    ]


def phase1_operators(device, ref_device, cases=None):
    """Every operator on `device` against `ref_device`, complex128 and
    complex64; raises after printing all of them if any is off."""
    cases = operator_cases() if cases is None else cases
    results = []
    for dtype in (jnp.complex128, jnp.complex64):
        for name, fn, args in cases:
            args = tuple(a.astype(dtype) for a in args)
            r = compare(run_on(fn, args, device), run_on(fn, args, ref_device), dtype)
            r.update(name=name, dtype=jnp.dtype(dtype).name)
            results.append(r)
            log(f"phase1 {name:24s} {r['dtype']:10s} max_abs={r['max_abs']:.3e} "
                f"rel={r['rel']:.3e} tol={r['tol']:.0e} {'ok' if r['ok'] else 'FAIL'}")
    bad = [f"{r['name']}/{r['dtype']}" for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"phase1: operators outside tolerance: {bad}")
    return results


# ------------------------------------------------------------------ phase 2


def wilson_hmc(staged=None) -> HMC:
    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-19, max_cg=3000)
    return HMC(action=ga.wilson_gauge_action(3, BETA), dtau=DTAU, md_steps=MDSTEPS,
               fermi_action=fa, staged=staged)


def action_size(stats) -> float:
    """Sum of |the six O(V) action terms| behind a trajectory's dH."""
    terms = ("sg_old", "sp_old", "sf_old", "sg_new", "sp_new", "sf_new")
    return float(sum(abs(float(stats[k])) for k in terms))


def trajectory_on(hmc, u_host, key_host, device) -> dict:
    u = jax.device_put(u_host, device)
    key = jax.device_put(key_host, device)
    with jax.default_device(device):
        u_out, _, st = hmc.step(u, key)
        u_out.block_until_ready()
    return {
        "accepted": bool(st["accepted"]),
        "dH": float(st["dH"]),
        "plaq": float(st["plaq"]),
        "action_size": action_size(st),
    }


def dh_tol(dtype, a: dict, b: dict) -> float:
    """|dH(a) - dH(b)| allowed: DH_ULPS of the real dtype at the summed
    |action terms|, and in complex128 at least DH_TOL_C128."""
    real = np.float64 if jnp.dtype(dtype) == jnp.complex128 else np.float32
    ulps = DH_ULPS * float(np.finfo(real).eps) * max(a["action_size"], b["action_size"])
    return max(DH_TOL_C128, ulps) if real is np.float64 else ulps


def phase2_trajectory(device, ref_device, lattice=TRAJ_LATTICE, seed=5):
    u_host = np.asarray(fields.hot_start(lattice, 3, seed=seed))
    key_host = np.asarray(jax.random.PRNGKey(seed))
    out = {}
    for dtype in (jnp.complex128, jnp.complex64):
        name = jnp.dtype(dtype).name
        hmc = wilson_hmc()
        got = trajectory_on(hmc, u_host.astype(dtype), key_host, device)
        ref = trajectory_on(hmc, u_host.astype(dtype), key_host, ref_device)
        d_dh = abs(got["dH"] - ref["dH"])
        d_plaq = abs(got["plaq"] - ref["plaq"])
        log(f"phase2 {name:10s} dH dev={got['dH']:.12g} cpu={ref['dH']:.12g} |d|={d_dh:.3e} "
            f"accept dev={got['accepted']} cpu={ref['accepted']} "
            f"plaq dev={got['plaq']:.15g} |d|={d_plaq:.3e}")
        assert np.isfinite(got["dH"]) and np.isfinite(ref["dH"]), (got, ref)
        tol = dh_tol(dtype, got, ref)
        log(f"phase2 {name} dH tolerance {tol:.3e}: max({DH_TOL_C128:.0e} in complex128, "
            f"{DH_ULPS} ulps of the summed |action terms| "
            f"{max(got['action_size'], ref['action_size']):.6g})")
        assert d_dh <= tol, f"phase2 {name} |ddH| {d_dh} > {tol}"
        if dtype == jnp.complex128:
            assert got["accepted"] == ref["accepted"], (got, ref)
            assert d_plaq <= PLAQ_TOL_C128, f"phase2 c128 |dplaq| {d_plaq} > {PLAQ_TOL_C128}"
        out[name] = (got, ref)
    return out


# ------------------------------------------------------------------ phase 3


def write_toml(path, tag, lattice=LATTICE, nsteps=NTRAJ, nr=3, chiral=True):
    """The main-path configuration in the repository's TOML schema."""
    chiral_line = (
        f'  {{methodname = "Chiral_condensate", measure_every = 1, Nr = {nr}, '
        f'fermion_parameters = {{Dirac_operator = "Wilson", hop = {KAPPA}}}}},\n'
        if chiral else "")
    text = f"""\
["Physical setting"]
L = {list(lattice)}
NC = 3
"β" = {BETA}
update_method = "HMC"
initial = "hot"
Nthermalization = 0
Nsteps = {nsteps}
randomseed = 111
quench = false

["Physical setting(fermions)"]
Dirac_operator = "Wilson"
hop = {KAPPA}
r = 1.0

["HMC related"]
MDsteps = {MDSTEPS}
"Δτ" = {DTAU}
eps = 1e-19
MaxCGstep = 3000

["System Control"]
verboselevel = 2
logfile = "{tag}.txt"
log_dir = "logs"
measurement_basedir = "measurements"
measurement_dir = "{tag}"

["Measurement set"]
measurement_methods = [
  {{methodname = "Plaquette", measure_every = 1}},
  {{methodname = "Polyakov_loop", measure_every = 1}},
{chiral_line}]
"""
    with open(path, "w") as f:
        f.write(text)
    return path


def solve_target(eps, dtype) -> float:
    """Relative |r|^2 the solver promises: eps clamped to the dtype, and
    for complex64 the attainable true-residual target of its verified exit."""
    eps = solvers._effective_eps(eps, dtype)
    if jnp.dtype(dtype) == jnp.complex64:
        eps = max(eps, solvers._VERIFY_FLOOR)
    return eps


@contextlib.contextmanager
def recording_solves():
    """Wrap solvers.cg for the duration: every CG solve traced meanwhile
    reports from inside its compiled program, through a host callback,
    its iterations and the true relative |b - A x|^2 of the x it
    returns (one more operator application per solve). Programs traced
    meanwhile keep the callback, so the jit caches are cleared on exit."""
    solves = []
    plain_cg = solvers.cg

    def cg(apply_a, b, x0=None, eps=1e-19, maxiter=3000):
        x, it, rsq = plain_cg(apply_a, b, x0=x0, eps=eps, maxiter=maxiter)
        r = b - apply_a(x)
        rel = jnp.real(jnp.vdot(r, r)) / jnp.real(jnp.vdot(b, b))
        info = {"target": solve_target(eps, b.dtype), "max_cg": maxiter}
        jax.debug.callback(
            lambda i, t: solves.append({**info, "iters": int(i), "true_rel_r2": float(t)}),
            it, rel)
        return x, it, rsq

    solvers.cg = cg
    try:
        yield solves
    finally:
        solvers.cg = plain_cg
        jax.clear_caches()


@contextlib.contextmanager
def recording_trajectories(solves=None):
    """Wrap HMC.step for the duration: per trajectory, its seconds
    (ending in block_until_ready), dH, accept, plaquette and summed
    |action terms|, and with `solves` (from recording_solves) the
    solves the trajectory ran."""
    records = []
    plain_step = HMC.step

    def step(self, u, key):
        jax.effects_barrier()
        first = len(solves) if solves is not None else 0
        t0 = time.perf_counter()
        u_out, key_out, st = plain_step(self, u, key)
        u_out.block_until_ready()
        rec = {
            "seconds": time.perf_counter() - t0,
            "dH": float(st["dH"]),
            "accepted": bool(st["accepted"]),
            "plaq": float(st["plaq"]),
            "action_size": action_size(st),
        }
        if solves is not None:
            jax.effects_barrier()
            rec["solves"] = solves[first:]
        records.append(rec)
        return u_out, key_out, st

    HMC.step = step
    try:
        yield records
    finally:
        HMC.step = plain_step


def phase3_main_path(workdir, clock, lattice=LATTICE, extra_args=()):
    from latticeqcd_tpu import run

    os.makedirs(workdir, exist_ok=True)
    out = {}
    for flag, tag in (("--f32", "c64"), ("--f64", "c128")):
        toml = write_toml(os.path.join(workdir, f"smoke_{tag}.toml"), f"smoke_{tag}", lattice)
        c0 = clock.total
        t0 = time.perf_counter()
        with contextlib.chdir(workdir), \
                open(os.path.join(workdir, f"driver_{tag}.out"), "w") as drv_out, \
                contextlib.redirect_stdout(drv_out), recording_solves() as solves, \
                recording_trajectories(solves) as recs:
            rc = run.main([toml, flag, *extra_args])
        wall = time.perf_counter() - t0
        assert rc == 0, f"phase3 {tag}: run.main returned {rc}"
        n_acc = 0
        for i, r in enumerate(recs, start=1):
            n_acc += r["accepted"]
            sv = r["solves"]
            log(f"phase3 {tag:4s} traj {i} seconds={r['seconds']:.3f} dH={r['dH']:.10g} "
                f"accepted={r['accepted']} acceptance={n_acc}/{i} plaq={r['plaq']:.10f} "
                f"solves={len(sv)} cg_iters={[s['iters'] for s in sv]} "
                f"max_true_rel_r2={max(s['true_rel_r2'] for s in sv):.3e} "
                f"(target {sv[0]['target']:.1e}, max_cg {sv[0]['max_cg']})")
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
        log(f"phase3 {tag:4s} wall={wall:.1f}s compile={clock.total - c0:.1f}s "
            f"peak_bytes_in_use={peak}")
        assert len(recs) == NTRAJ, recs
        for r in recs:
            assert np.isfinite(r["dH"]), r
            assert 0.0 < r["plaq"] < 1.0, r
            # a force solve per MD step and the action solve at the end
            assert len(r["solves"]) >= MDSTEPS + 1, r
            for sv in r["solves"]:
                assert sv["iters"] < sv["max_cg"], sv
                assert sv["true_rel_r2"] <= SOLVE_SLACK * sv["target"], sv
        mdir = os.path.join(workdir, "measurements", f"smoke_{tag}")
        for name in ("Plaquette", "Polyakov_loop", "Chiral_condensate"):
            path = os.path.join(mdir, f"{name}.txt")
            assert os.path.getsize(path) > 0, f"phase3 {tag}: {path} is empty"
        with open(os.path.join(mdir, "Plaquette.txt")) as f:
            assert len(f.read().split("\n")) - 1 == NTRAJ + 1, "Plaquette.txt line count"
        out[tag] = recs
    return out, toml


# ------------------------------------------------------------------ phase 4


def rel_diff(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(a)), abs(float(b)), np.finfo(np.float64).tiny)


def phase4_staged_vs_fused(toml, clock):
    """One complex64 trajectory each way from the same links and key.
    They must return the same accept decision, and the same outgoing
    links, plaquette and proposal action terms (gauge, kinetic and
    fermion action of the MD end point, which a rejected trajectory does
    not hand back) within float32 rounding. dH is printed only: at this
    volume its complex64 value is a few float32 ulps of ~1e8."""
    from latticeqcd_tpu.system.params import construct_params_from_toml
    from latticeqcd_tpu.system.universe import build_universe
    from latticeqcd_tpu.updates.factory import updatemethod

    p = construct_params_from_toml(toml, make_dirs=False)
    p.logfile = ""
    univ = build_universe(p, dtype=jnp.complex64)
    hmc = updatemethod(p, univ)
    key = jax.random.PRNGKey(p.randomseed)
    res = {}
    for staged in (True, False):
        h = dataclasses.replace(hmc, staged=staged)
        c0 = clock.total
        t0 = time.perf_counter()
        u1, _, st = h.step(univ.u, key)
        u1.block_until_ready()
        first = time.perf_counter() - t0
        compile_s = clock.total - c0
        t0 = time.perf_counter()
        u2, _, _ = h.step(univ.u, key)
        u2.block_until_ready()
        run_s = time.perf_counter() - t0
        del u2
        name = "staged" if staged else "fused"
        res[name] = {"u": u1, "compile_s": compile_s, "first_s": first, "run_s": run_s,
                     "accepted": bool(st["accepted"]), "dH": float(st["dH"]),
                     "plaq": float(st["plaq"]),
                     **{k: float(st[k]) for k in PROPOSAL_TERMS}}
        log(f"phase4 {name:6s} compile={compile_s:.2f}s first_call={first:.2f}s "
            f"run={run_s:.3f}s dH={float(st['dH']):.6g} accepted={bool(st['accepted'])}")
    a, b = res["staged"], res["fused"]
    diffs = {
        "links": float(jnp.max(jnp.abs(a["u"] - b["u"])) / jnp.max(jnp.abs(b["u"]))),
        "plaq": rel_diff(a["plaq"], b["plaq"]),
        **{k: rel_diff(a[k], b[k]) for k in PROPOSAL_TERMS},
    }
    faster = min(res, key=lambda k: res[k]["run_s"])
    log(f"phase4 staged vs fused: accepted {a['accepted']}/{b['accepted']}, relative "
        + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
        + f" (tol {STAGED_REL_TOL:.0e}); dH {a['dH']:.6g}/{b['dH']:.6g} (not compared); "
        f"faster path: {faster}; default for this backend: "
        f"{'staged' if hmc._use_staged() else 'fused'}")
    assert a["accepted"] == b["accepted"], "phase4: accept decisions differ"
    bad = [k for k, v in diffs.items() if not v <= STAGED_REL_TOL]
    assert not bad, f"phase4: staged and fused differ in {bad}: {diffs}"
    for r in res.values():
        del r["u"]
    return res


# ------------------------------------------------------------------ phase 5


def median_seconds(fn, args, n=20):
    fn(*args).block_until_ready()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts)), float(np.max(ts))


def phase5_kernels(lattice=LATTICE, n=20):
    vol = int(np.prod(lattice))
    half = (lattice[0] // 2,) + tuple(lattice[1:])
    wd = WilsonDirac(kappa=KAPPA)
    sd = StaggeredDirac(mass=0.1, lattice=tuple(lattice))
    u = apply_boundary_phases(fields.hot_start(lattice, 3, seed=0))
    psi = gaussian_spinor(jax.random.PRNGKey(1), lattice, 3)
    chi = gaussian_spinor(jax.random.PRNGKey(2), half, 3, nspin=1)
    out = {}
    for dtype in (jnp.complex64, jnp.complex128):
        item = jnp.dtype(dtype).itemsize
        uu = u.astype(dtype)
        ueo = jax.jit(sd.packed_links)(uu)
        for name, fn, args, cplx in (
            ("wilson_D", jax.jit(wd.apply), (uu, psi.astype(dtype)), WILSON_COMPLEX_PER_SITE),
            ("staggered_W_packed", jax.jit(sd.apply_w_packed), (ueo, chi.astype(dtype)),
             STAGGERED_W_COMPLEX_PER_SITE),
        ):
            med, lo, hi = median_seconds(fn, args, n)
            gbs = cplx * item * vol / med / 1e9
            key = f"{name}/{jnp.dtype(dtype).name}"
            out[key] = {"median_us": med * 1e6, "min_us": lo * 1e6, "max_us": hi * 1e6,
                        "gb_per_s": gbs}
            log(f"phase5 {name:18s} {jnp.dtype(dtype).name:10s} median={med * 1e6:.1f}us "
                f"min={lo * 1e6:.1f}us max={hi * 1e6:.1f}us (n={n}) "
                f"{gbs:.0f} GB/s at {cplx * item} B/site")
    return out


# ------------------------------------------------------------- four cards


def phase_four_cards(workdir, lattice=LATTICE, devices=None):
    """The Phase 3 configuration in complex128 through run_lqcd_file
    sharded over PEs (1,1,1,4) and (1,1,2,2), then on one card; each
    sharded run is compared with the one-card run. The chiral condensate
    measurement is left out here: its solves add a compile per mesh and
    check nothing the trajectories do not."""
    from latticeqcd_tpu.parallel import make_lattice_mesh
    from latticeqcd_tpu.system.lqcd import run_lqcd_file

    devices = jax.devices()[:4] if devices is None else devices
    if len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, JAX sees {len(devices)}")
    os.makedirs(workdir, exist_ok=True)
    runs = {}
    for pes in ((1, 1, 1, 4), (1, 1, 2, 2), None):
        tag = "single" if pes is None else "pes" + "".join(map(str, pes))
        toml = write_toml(os.path.join(workdir, f"four_{tag}.toml"), f"four_{tag}", lattice,
                          chiral=False)
        mesh = None if pes is None else make_lattice_mesh(pes, devices=devices)
        t0 = time.perf_counter()
        with contextlib.chdir(workdir), \
                open(os.path.join(workdir, f"driver_four_{tag}.out"), "w") as drv_out, \
                contextlib.redirect_stdout(drv_out), recording_trajectories() as recs:
            plaq = run_lqcd_file(toml, dtype=jnp.complex128, shard_mesh=mesh)
        runs[tag] = (recs, plaq)
        secs = " ".join(f"{r['seconds']:.3f}" for r in recs)
        log(f"four_cards {tag:9s} wall={time.perf_counter() - t0:.1f}s seconds/traj=[{secs}] "
            f"dH=[{' '.join(f'{r['dH']:.12g}' for r in recs)}] "
            f"accepted={[r['accepted'] for r in recs]} final_plaq={plaq:.15g}")
    ref_recs, ref_plaq = runs.pop("single")
    for tag, (recs, plaq) in runs.items():
        d_dh = [abs(a["dH"] - b["dH"]) for a, b in zip(recs, ref_recs)]
        tols = [dh_tol(jnp.complex128, a, b) for a, b in zip(recs, ref_recs)]
        d_plaq = abs(plaq - ref_plaq)
        log(f"four_cards {tag} vs single: |ddH|=[{' '.join(f'{d:.3e}' for d in d_dh)}] "
            f"(tol [{' '.join(f'{t:.1e}' for t in tols)}]) "
            f"|dplaq|={d_plaq:.3e} (tol {PLAQ_TOL_SHARDED:.0e})")
        assert len(recs) == len(ref_recs) == NTRAJ, tag
        assert [r["accepted"] for r in recs] == [r["accepted"] for r in ref_recs], tag
        assert all(d <= t for d, t in zip(d_dh, tols)) and d_plaq <= PLAQ_TOL_SHARDED, tag
    return runs


# --------------------------------------------------------------------- main


def plan(argv) -> list:
    """The phases the given arguments select, in order."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded driver on four GPUs (after the device check)")
    args = ap.parse_args(argv)
    if args.four_cards:
        return ["device", "four_cards"]
    return ["device", "operators", "trajectory", "main_path", "staged_vs_fused", "kernels"]


def main(argv=None) -> int:
    phases = plan(sys.argv[1:] if argv is None else argv)
    jax.config.update("jax_enable_x64", True)
    cache_dir = configure_compile_cache()
    clock = CompileClock()
    t_start = time.perf_counter()
    dev = phase0_device(cache_dir)
    cpu = jax.devices("cpu")[0]
    toml = None
    for phase in phases[1:]:
        t0 = time.perf_counter()
        if phase == "operators":
            phase1_operators(dev, cpu)
        elif phase == "trajectory":
            phase2_trajectory(dev, cpu)
        elif phase == "main_path":
            _, toml = phase3_main_path(WORKDIR, clock)
        elif phase == "staged_vs_fused":
            phase4_staged_vs_fused(toml, clock)
        elif phase == "kernels":
            phase5_kernels()
        elif phase == "four_cards":
            phase_four_cards(WORKDIR)
        log(f"# {phase} done in {time.perf_counter() - t0:.1f}s")
    log(f"# total {time.perf_counter() - t_start:.1f}s, compile {clock.total:.1f}s")
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
