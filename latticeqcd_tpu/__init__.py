"""Lattice QCD sampling engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
LatticeQCD.jl (akio-tomiya/LatticeQCD.jl) and its satellite packages
(Gaugefields.jl, LatticeDiracOperators.jl, QCDMeasurements.jl,
Wilsonloop.jl): SU(N) gauge fields with general loop-based actions,
heatbath + overrelaxation, quenched and dynamical HMC (Wilson,
staggered, domain-wall), staggered RHMC, stout smearing, gradient
flow, the full measurement suite, and ILDG / Bridge++-text / native
config I/O, sharded over device meshes with halo exchange via XLA
collectives.

Top-level API mirrors the reference facade
(/root/reference/src/LatticeQCD.jl:157-174): `run_LQCD`,
`run_LQCD_file`, `run_wizard`, `Params`.
"""

from latticeqcd_tpu._version import __version__


def run_LQCD(filename, **kwargs):
    """Run a full lattice-QCD simulation from a TOML parameter file.

    Mirrors run_LQCD at /root/reference/src/system/lqcd.jl:31-34.
    Returns the final-trajectory mean plaquette (used by the test
    suite, lqcd.jl:186-193).
    """
    from latticeqcd_tpu.system.lqcd import run_lqcd_file

    return run_lqcd_file(filename, **kwargs)


def run_LQCD_file(filename, **kwargs):
    from latticeqcd_tpu.system.lqcd import run_lqcd_file

    return run_lqcd_file(filename, **kwargs)


def run_wizard(*args, **kwargs):
    from latticeqcd_tpu.system.wizard import run_wizard as _run_wizard

    return _run_wizard(*args, **kwargs)


__all__ = ["run_LQCD", "run_LQCD_file", "run_wizard", "__version__"]
