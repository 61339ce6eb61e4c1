"""Benchmark on one NVIDIA GPU. Prints one JSON line; fails without a GPU.

Tiers, each in a fresh subprocess (this parent process never imports
JAX, so only one process at a time holds the card):

  T1  Wilson D-slash mat-vec, 16^3x32, complex64 -> median microseconds
      per apply over 20 timed applies, each ending in
      block_until_ready, with GFLOP/s (1320 flop/site) and GB/s at the
      minimum traffic of 480 B/site. Gated on a device-vs-CPU output
      check.
  T2  The reference's only published benchmark: 20 HMC trajectories,
      2-flavor Wilson, 4^4, beta=6.0, kappa=0.141139, r=1, MDsteps=10,
      dtau=0.1 (docs/src/index.md:112-160) -> wall-clock seconds,
      vs_baseline = 180.41 s (Mac mini 2018 i7) / ours. The chain starts
      from a seeded hot start, thermalized by 20 untimed trajectories
      that also compile the step, and must end in the plaquette band.

Usage: python bench.py            (all tiers)
       python bench.py --tier1    (one tier, in this process)
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_SECONDS = 180.41  # reference docs/src/index.md:148-154
TIER_TIMEOUT_S = 900

# Wilson D-slash: 1320 flop/site (standard count); the minimum memory
# traffic is 480 B/site in complex64 (read a 12-component spinor, 96 B,
# and four 3x3 links, 288 B; write a spinor, 96 B). Full math in PERF.md.
DSLASH_FLOP_PER_SITE = 1320
DSLASH_BYTES_PER_SITE_C64 = 480
V16 = 16**3 * 32


def _setup_jax():
    import jax

    from latticeqcd_tpu.utils.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's first device is {dev.platform!r}")
    configure_compile_cache()
    return jax


def _device(jax) -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def _validate_c64_dslash(jax):
    """Output-validity gate: before any timing is trusted, apply the
    production Wilson D-slash to a small deterministic problem on the
    device and compare elementwise against the CPU backend's answer on
    byte-identical inputs. Raises on mismatch, so the tier fails."""
    import numpy as np
    import jax.numpy as jnp

    from latticeqcd_tpu.ops import fields
    from latticeqcd_tpu.ops.dirac.wilson import (
        WilsonDirac, apply_boundary_phases, gaussian_spinor,
    )

    cpu = jax.local_devices(backend="cpu")[0]
    lat = (8, 8, 8, 8)
    d = WilsonDirac(kappa=0.141139)
    with jax.default_device(cpu):
        u = apply_boundary_phases(
            fields.hot_start(lat, 3, seed=7, dtype=jnp.complex64))
        psi = gaussian_spinor(jax.random.PRNGKey(8), lat, 3, nspin=4,
                              dtype=jnp.complex64)
        ref = np.asarray(jax.jit(d.apply)(u, psi))
    u_d = jax.device_put(np.asarray(u), jax.devices()[0])
    psi_d = jax.device_put(np.asarray(psi), jax.devices()[0])
    got = np.asarray(jax.jit(d.apply)(u_d, psi_d))
    err = float(np.max(np.abs(ref - got)))
    if not np.isfinite(err) or err > 1e-4:
        raise RuntimeError(
            f"device output validity check FAILED: max|cpu-dev| = {err}")


# ----------------------------------------------------------------- tiers


def tier1_dslash(n=20):
    """Jitted Wilson D-slash at 16^3x32 c64 -> median us, GFLOP/s, GB/s."""
    jax = _setup_jax()
    import jax.numpy as jnp
    import numpy as np

    from latticeqcd_tpu.ops import fields
    from latticeqcd_tpu.ops.dirac.wilson import (
        WilsonDirac,
        apply_boundary_phases,
        gaussian_spinor,
    )

    _validate_c64_dslash(jax)
    lat = (16, 16, 16, 32)
    u = apply_boundary_phases(fields.hot_start(lat, 3, seed=0, dtype=jnp.complex64))
    psi = gaussian_spinor(jax.random.PRNGKey(1), lat, 3, nspin=4, dtype=jnp.complex64)
    f = jax.jit(WilsonDirac(kappa=0.141139).apply)
    f(u, psi).block_until_ready()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        f(u, psi).block_until_ready()
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    return {
        "dslash_us": dt * 1e6,
        "dslash_us_min": min(ts) * 1e6,
        "dslash_us_max": max(ts) * 1e6,
        "n": n,
        "dslash_gflops": DSLASH_FLOP_PER_SITE * V16 / dt / 1e9,
        "dslash_gb_per_s": DSLASH_BYTES_PER_SITE_C64 * V16 / dt / 1e9,
        "device": _device(jax),
        "validity": "device output checked vs CPU on 8^4 (max|diff|<1e-4)",
    }


def tier2_hmc(n_traj=20, n_therm=20):
    """The reference headline workload -> {wall_s, plaquette, accepted}."""
    jax = _setup_jax()
    jax.config.update("jax_enable_x64", True)
    import math

    import jax.numpy as jnp

    from latticeqcd_tpu.ops import fields
    from latticeqcd_tpu.ops import gauge_action as ga
    from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac
    from latticeqcd_tpu.ops.fermion_action import WilsonFermiAction
    from latticeqcd_tpu.updates import HMC

    dtype = jnp.complex128
    u = fields.hot_start((4, 4, 4, 4), 3, seed=100, dtype=dtype)
    fa = WilsonFermiAction(WilsonDirac(kappa=0.141139, r=1.0), eps_cg=1e-19, max_cg=3000)
    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=10, fermi_action=fa)

    key = jax.random.PRNGKey(111)
    for _ in range(n_therm):  # thermalize; the first call compiles
        u, key, st = hmc.step(u, key)
    u.block_until_ready()

    t0 = time.perf_counter()
    n_acc = 0
    for _ in range(n_traj):
        u, key, st = hmc.step(u, key)
        n_acc += int(st["accepted"])
    u.block_until_ready()
    wall = time.perf_counter() - t0
    plaq = float(st["plaq"])
    # physics validity gate: the 4^4 beta=6.0 2f Wilson chain must sit
    # in the equilibrium band once thermalized
    if not math.isfinite(plaq) or not (0.40 < plaq < 0.80):
        raise RuntimeError(
            f"tier2 physics validity FAILED: final plaquette {plaq} outside "
            "(0.40, 0.80) equilibrium band")
    return {
        "wall_s": wall,
        "final_plaquette": plaq,
        "accepted": n_acc,
        "precision": str(jnp.dtype(dtype)),
        "eps_cg": fa.eps_cg,
        "device": _device(jax),
        "validity": "final plaquette within (0.40, 0.80) equilibrium band",
    }


TIERS = {"--tier1": tier1_dslash, "--tier2": tier2_hmc}


# ----------------------------------------------------- orchestration


def _gpu_name_and_power() -> str:
    """`nvidia-smi` name and power limit of the first card (no JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.CalledProcessError) as e:
        raise SystemExit(f"bench.py needs a GPU; nvidia-smi failed: {e}") from e
    return r.stdout.splitlines()[0].strip()


def _run_tier(flag: str) -> dict:
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag],
        timeout=TIER_TIMEOUT_S, capture_output=True, text=True,
    )
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-4000:])
        raise SystemExit(f"bench.py: tier {flag} failed with exit code {r.returncode}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for flag, tier in TIERS.items():
        if flag in argv:
            print(json.dumps(tier()))
            return 0
    gpu = _gpu_name_and_power()
    t1 = _run_tier("--tier1")
    t2 = _run_tier("--tier2")
    print(json.dumps({
        "metric": "wilson_hmc_20traj_4^4_beta6.0_kappa0.141139_wallclock",
        "value": t2["wall_s"],
        "unit": "s",
        "vs_baseline": BASELINE_SECONDS / t2["wall_s"],
        "baseline": f"{BASELINE_SECONDS} s LatticeQCD.jl on 2018 Mac mini i7 (CPU)",
        "device": t2["device"],
        "gpu": gpu,
        "tier1": t1,
        "tier2": t2,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
