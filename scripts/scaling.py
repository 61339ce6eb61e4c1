"""Weak/strong scaling harness for HMC over a device mesh.

North-star metric (BASELINE.md): trajectories/s at 1 chip, 1 host and
N>=2 hosts with >=80% weak-scaling efficiency for HMC on 16^3x32.

Usage:
    python scripts/scaling.py [--devices N] [--lat 16,16,16,32]
                              [--dynamical] [--mode weak|strong|both]
                              [--cpu]

On a multi-chip platform this uses the real devices; with --cpu (or on
a single-chip host) it validates the SPMD path on N virtual CPU
devices (XLA_FLAGS=--xla_force_host_platform_device_count). Weak
scaling grows the t extent with the device count (constant per-device
volume); strong scaling keeps the global lattice fixed. Efficiency is
(throughput_N / (N * throughput_1)) for weak, measured against the
single-device run of the same global problem for strong.

Prints one JSON line per configuration.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0, help="0 = all available")
    ap.add_argument("--lat", default="16,16,16,32")
    ap.add_argument("--dynamical", action="store_true")
    ap.add_argument("--mode", default="both", choices=("weak", "strong", "both"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ntraj", type=int, default=3)
    args = ap.parse_args()

    if args.cpu:
        n = args.devices or 8
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n}"
        )

    import jax

    from latticeqcd_tpu.utils.compile_cache import configure_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    configure_compile_cache()

    import jax.numpy as jnp

    from latticeqcd_tpu.ops import fields, gauge_action as ga
    from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_tpu.ops.fermion_action import StaggeredFermiAction
    from latticeqcd_tpu.parallel import default_pes, make_lattice_mesh, shard_links
    from latticeqcd_tpu.updates import HMC

    base_lat = tuple(int(x) for x in args.lat.split(","))
    n_avail = len(jax.devices())
    n_dev = args.devices or n_avail
    dtype = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64

    def build_hmc(lattice):
        fa = None
        if args.dynamical:
            fa = StaggeredFermiAction(
                StaggeredDirac(mass=0.5, lattice=lattice), nf=4,
                eps_cg=1e-10, max_cg=1000,
            )
        return HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05,
                   md_steps=10, fermi_action=fa)

    def run(lattice, ndev):
        u = fields.hot_start(lattice, 3, seed=0, dtype=dtype)
        if ndev > 1:
            pes = default_pes(ndev)
            mesh = make_lattice_mesh(pes, devices=jax.devices()[:ndev])
            u = shard_links(u, mesh)
        hmc = build_hmc(lattice)
        key = jax.random.PRNGKey(0)
        u, key, _ = hmc.step(u, key)  # compile
        jax.block_until_ready(u)
        t0 = time.time()
        for _ in range(args.ntraj):
            u, key, _ = hmc.step(u, key)
        jax.block_until_ready(u)
        return args.ntraj / (time.time() - t0)

    kind = "dynamical_staggered" if args.dynamical else "quenched"
    results = []

    base_rate = run(base_lat, 1)
    results.append({"mode": "base", "devices": 1, "lat": base_lat,
                    "traj_per_s": round(base_rate, 4), "kind": kind})

    if args.mode in ("weak", "both") and n_dev > 1:
        weak_lat = base_lat[:3] + (base_lat[3] * n_dev,)
        rate = run(weak_lat, n_dev)
        eff = rate / base_rate  # same per-device volume -> ideal = 1.0
        results.append({"mode": "weak", "devices": n_dev, "lat": weak_lat,
                        "traj_per_s": round(rate, 4),
                        "efficiency": round(eff, 3), "kind": kind})

    if args.mode in ("strong", "both") and n_dev > 1:
        rate = run(base_lat, n_dev)
        eff = rate / (base_rate * n_dev)
        results.append({"mode": "strong", "devices": n_dev, "lat": base_lat,
                        "traj_per_s": round(rate, 4),
                        "efficiency": round(eff, 3), "kind": kind})

    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
