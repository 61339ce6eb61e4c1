"""CLI entry: python -m latticeqcd_tpu.run parameters.toml

Counterpart of src/run.jl (SURVEY.md layer L7;
/root/reference/src/run.jl:19-27).
"""

import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print(
            "usage: python -m latticeqcd_tpu.run <parameters.toml> [--f64|--f32]"
            " [--cpu] [--resume checkpoint.npz] [--profile tracedir]"
        )
        return 2
    dtype_flag = "--f64"
    resume = None
    profile_dir = None
    force_cpu = False
    args = []
    it = iter(argv)
    for a in it:
        if a == "--resume":
            resume = next(it)
        elif a == "--profile":
            profile_dir = next(it)
        elif a == "--f32":
            dtype_flag = "--f32"
        elif a == "--f64":
            dtype_flag = "--f64"
        elif a == "--cpu":
            force_cpu = True  # run on the host CPU even where a GPU is present
        elif a.startswith("--"):
            print(f"unknown flag {a!r}")
            return 2
        else:
            args.append(a)

    import jax

    from latticeqcd_tpu.utils.compile_cache import configure_compile_cache

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        print(f"no GPU found (JAX backend {jax.default_backend()!r}); "
              "pass --cpu to run on the host CPU", file=sys.stderr)
        return 2
    configure_compile_cache()
    if dtype_flag == "--f64":
        jax.config.update("jax_enable_x64", True)
        dtype = "complex128"
    else:
        dtype = "complex64"
    import jax.numpy as jnp

    from latticeqcd_tpu.system.lqcd import run_lqcd_file

    t0 = time.time()
    plaq = run_lqcd_file(
        args[0], dtype=jnp.dtype(dtype), resume_checkpoint=resume, profile_dir=profile_dir
    )
    print(f"final plaquette = {plaq}")
    print(f"elapsed {time.time()-t0:.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
