"""bench.py harness logic on the CPU: the GPU requirement and the
output-validity gate.

On the CPU suite jax.devices() resolves to CPU devices, so the gate's
"device" side and its CPU reference both land on the CPU backend — the
comparison machinery (device_put routing, elementwise diff) runs for
real.
"""

import importlib.util
import os

import jax
import pytest


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "benchmod", os.path.join(os.path.dirname(__file__), "..", "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_refuses_without_gpu(bench):
    """Every tier checks the device before any work: on the CPU suite
    it exits instead of timing the CPU."""
    for tier in bench.TIERS.values():
        with pytest.raises(SystemExit, match="needs a GPU"):
            tier()


def test_validity_gates_pass_on_faithful_device(bench):
    """jax.devices() resolves to the CPU devices of the test suite, so
    'device' output == CPU reference and the gate must pass; this runs
    its full body (routing, diff)."""
    bench._validate_c64_dslash(jax)


def test_validity_gate_fails_on_garbage(bench, monkeypatch):
    """If the 'device' computes garbage the gate must raise. Simulate
    by corrupting what the device side sees: patch device_put to zero
    complex arrays."""
    import numpy as np

    real_put = jax.device_put

    def corrupting_put(x, device=None):
        arr = np.asarray(x)
        if device is not None and device in jax.devices() and np.iscomplexobj(arr):
            return real_put(np.zeros_like(arr), device)
        return real_put(x, device)

    monkeypatch.setattr(jax, "device_put", corrupting_put)
    with pytest.raises(RuntimeError, match="validity check FAILED"):
        bench._validate_c64_dslash(jax)
