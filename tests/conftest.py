"""Test harness: 8 virtual CPU devices, float64 enabled.

The suite runs on the CPU even on a machine with a GPU: the platform
is pinned to "cpu" before any backend initializes, and multi-device
sharding is validated on a virtual 8-device CPU mesh (SURVEY.md 2.5).
What runs only on the GPU is checked by `python chip_smoke.py`.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REFERENCE = "/root/reference"

# Root cause of the round-2 "xdist flake" (reproduced 6x on 2026-08-21
# in full-suite -n 2 runs, faulthandler stacks captured): a NATIVE
# SEGFAULT inside XLA:CPU's backend_compile_and_load compiling
# fermion-HMC programs — 5 of 6 in test_rhmc_spectral_bound_check's
# power-iteration compile, 1 in Hasenbusch sampling. The signature is
# a LONG-LIVED worker process (hundreds of prior compiles): the same
# compile always succeeds in isolation and on a fresh worker, so this
# is process-state-dependent corruption inside the pinned XLA, not a
# property of any test. Ruled out empirically: OOM (128 GB box, no
# dmesg events), main-thread stack overflow (passes at ulimit -s
# 2048), --xla_cpu_parallel_codegen_split_count=1 (crash recurred),
# disabling CPU async dispatch (crash recurred). Not patchable from
# this repo (pinned jax, no network), so contain at the harness:
# reschedule a crash-killed test ONCE on a fresh worker
# (pytest_handlecrashitem). Validated 2026-08-21: 3 consecutive full
# -n 2 suites green (235 passed, 1 contained rerun each). A test that
# crashes twice still fails the suite, so a genuine persistent crash
# cannot hide.
_crash_retried: set = set()


def pytest_handlecrashitem(crashitem, report, sched):
    if crashitem not in _crash_retried:
        _crash_retried.add(crashitem)
        sched.mark_test_pending(crashitem)
        report.outcome = "rerun"
        report.longrepr = (
            f"{report.longrepr} — rescheduled once (known XLA:CPU "
            "compile-time segfault race, see conftest.py)"
        )


@pytest.fixture(scope="session")
def reference_dir():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference checkout not available")
    return REFERENCE
