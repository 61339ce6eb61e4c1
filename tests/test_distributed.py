"""Two-process jax.distributed correctness test (VERDICT.md item 4).

The reference's MPI path is launched as `mpirun -np N julia mpirun.jl
params.toml PE1..PE4` (/root/reference/src/mpirun.jl:14-25). The
analog here is one `latticeqcd_tpu.multirun` process per host joined
by jax.distributed. This test spawns TWO local processes, each with 4
virtual CPU devices, over an explicit coordinator; the global mesh is
(1, 1, 2, 4) — identical to the single-process layout — so the SPMD
partitioning (and hence every reduction order) matches and the final
plaquette must agree to near-bitwise with a single-process run.

Also pins the rank-0 gating: only process 0 prints driver output and
writes configs.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WRAPPER = textwrap.dedent(
    """
    import os, sys
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
        )
    import jax
    jax.config.update("jax_platforms", "cpu")
    from latticeqcd_tpu import multirun
    sys.exit(multirun.main(sys.argv[1:] + ["--cpu"]))
    """
)

TOML = """
["Physical setting"]
L = [4, 4, 4, 4]
NC = 2
"β" = 1.9
update_method = "HMC"
quench = true
Nsteps = 2
Nthermalization = 0
randomseed = 111
initial = "hot"
verboselevel = 1

["System Control"]
logfile = ""
log_dir = "{log_dir}"
saveU_format = "NPZ"
saveU_every = 1
saveU_dir = "{save_dir}"
measurement_basedir = "{meas_dir}"
measurement_dir = "dist"

["HMC related"]
MDsteps = 4
"Δτ" = 0.25
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_matches_single(tmp_path):
    wrapper = tmp_path / "wrapper.py"
    wrapper.write_text(WRAPPER)

    def write_toml(tag):
        d = tmp_path / tag
        (d / "logs").mkdir(parents=True)
        (d / "saves").mkdir()
        (d / "meas").mkdir()
        toml = d / "params.toml"
        toml.write_text(
            TOML.format(log_dir=d / "logs", save_dir=d / "saves", meas_dir=d / "meas")
        )
        return d, toml

    port = _free_port()
    d2, toml2 = write_toml("twoproc")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = []
    for rank in (0, 1):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, str(wrapper), str(toml2), "1", "1", "2", "4",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--nprocs", "2", "--procid", str(rank),
                ],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=env, cwd=REPO, text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out}\n{err}"

    # rank-0 gating: driver output only from process 0
    assert "final plaquette =" in outs[0][1]
    assert "final plaquette =" not in outs[1][1]
    assert "itrj" not in outs[1][1]
    plaq2 = float(outs[0][1].split("final plaquette =")[1].split()[0])

    # configs were saved (by rank 0; both ranks share the filesystem here,
    # so "exactly Nsteps files" also proves no double-writing race)
    saved = sorted(
        f for f in os.listdir(d2 / "saves")
        if f.startswith("conf_") and f.endswith(".npz")
    )
    assert len(saved) == 2, saved

    # single-process run, same global mesh layout -> same SPMD program
    d1, toml1 = write_toml("oneproc")
    r = subprocess.run(
        [sys.executable, str(wrapper), str(toml1), "1", "1", "2", "4"],
        capture_output=True,
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
        cwd=REPO, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    plaq1 = float(r.stdout.split("final plaquette =")[1].split()[0])
    assert abs(plaq1 - plaq2) < 1e-10, (plaq1, plaq2)
