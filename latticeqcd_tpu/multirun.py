"""Multi-device / multi-host entry:

    python -m latticeqcd_tpu.multirun params.toml [PE1 PE2 PE3 PE4] \
        [--cpu] [--coordinator host:port --nprocs N --procid I]

Counterpart of src/mpirun.jl (SURVEY.md layer L7;
/root/reference/src/mpirun.jl:14-25) — but instead of MPI ranks the
4-vector PEs selects the jax device-mesh layout; the link field is
sharded over the mesh and every jitted step runs SPMD with XLA
collectives (NCCL over NVLink between the GPUs of one host;
SURVEY.md 2.5).

One process drives every GPU of its host, so a single-host run needs
no flags. Several hosts (the `mpirun -np N` analog): launch one copy
of this process per host with --coordinator/--nprocs/--procid. The
driver loop is replicated on every process exactly like the
reference's rank-replicated driver; logging, measurement files and
config saves are rank-0 gated. --cpu runs on the host's CPU devices
instead of GPUs.
"""

import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv

    coordinator = None
    nprocs = None
    procid = None
    force_cpu = False
    pos = []
    it = iter(argv)
    for a in it:
        if a == "--coordinator":
            coordinator = next(it)
        elif a == "--nprocs":
            nprocs = int(next(it))
        elif a == "--procid":
            procid = int(next(it))
        elif a == "--cpu":
            force_cpu = True
        else:
            pos.append(a)
    if len(pos) not in (1, 5):
        print(
            "usage: python -m latticeqcd_tpu.multirun <params.toml> "
            "[PE1 PE2 PE3 PE4] [--cpu] [--coordinator host:port --nprocs N --procid I]"
        )
        return 2

    import jax

    from latticeqcd_tpu.parallel import initialize_multihost
    from latticeqcd_tpu.utils.compile_cache import configure_compile_cache

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    if coordinator is not None or nprocs is not None:
        initialize_multihost(coordinator, nprocs, procid)
    if not force_cpu and jax.default_backend() != "gpu":
        print(f"no GPU found (JAX backend {jax.default_backend()!r}); "
              "pass --cpu to run on the host CPU", file=sys.stderr)
        return 2
    configure_compile_cache()
    jax.config.update("jax_enable_x64", True)

    from latticeqcd_tpu.parallel import (
        default_pes,
        make_lattice_mesh,
        println_rank0,
        set_PEs,
    )
    from latticeqcd_tpu.system.lqcd import run_lqcd_file

    n = len(jax.devices())
    if len(pos) == 5:
        pes = tuple(int(x) for x in pos[1:5])
    else:
        pes = default_pes(n)
    set_PEs(pes)
    mesh = make_lattice_mesh(pes)
    println_rank0(
        f"# device mesh {pes} over {n} devices, "
        f"{jax.process_count()} process(es)"
    )

    t0 = time.time()
    plaq = run_lqcd_file(pos[0], shard_mesh=mesh)
    println_rank0(f"final plaquette = {plaq}")
    println_rank0(f"elapsed {time.time()-t0:.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
