"""ops/dots.py: small contractions as multiply-and-sum. They agree with
jnp.einsum / jnp.matmul to rounding, and the operators built on them
lower to no dot_general (which XLA:GPU would hand to cuBLAS)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from latticeqcd_tpu.ops import dots, fields, gauge_action as ga
from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac
from latticeqcd_tpu.ops.dirac.staggered import StaggeredDirac
from latticeqcd_tpu.ops.dirac.wilson import WilsonDirac, apply_boundary_phases, gaussian_spinor

LAT = (4, 4, 4, 4)
RTOL = {jnp.complex64: 1e-6, jnp.complex128: 1e-14}

# every subscript pattern the operators use, with operand shapes
PATTERNS = [
    ("...ab,...sb->...sa", (*LAT, 3, 3), (*LAT, 4, 3)),
    ("...ba,...hb->...ha", (*LAT, 3, 3), (*LAT, 2, 3)),
    ("st,...tc->...sc", (4, 4), (*LAT, 4, 3)),
    ("sh,...sc->...hc", (4, 2), (*LAT, 4, 3)),
    ("...ab,...b->...a", (*LAT, 3, 3), (*LAT, 3)),
    ("...ab,l...sb->l...sa", (*LAT, 3, 3), (4, *LAT, 4, 3)),
    ("lk,k...->l...", (4, 4), (4, *LAT, 4, 3)),
    ("st,...ab->...satb", (4, 4), (*LAT, 3, 3)),
    ("...satb,...tb->...sa", (*LAT, 4, 3, 4, 3), (*LAT, 4, 3)),
    ("k...,...->k", (5, *LAT, 3), (*LAT, 3)),
    ("jk,j...->k...", (5, 4), (5, *LAT, 3)),
    ("k...,n...->nk", (4, *LAT, 3), (6, *LAT, 3)),
    ("k,k...->...", (5,), (5, *LAT, 3)),
]


def _rand(key, shape, dtype):
    k1, k2 = jax.random.split(key)
    rdt = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    return (jax.random.normal(k1, shape, rdt) + 1j * jax.random.normal(k2, shape, rdt)).astype(dtype)


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
@pytest.mark.parametrize("sub,sx,sy", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_einsum_matches_jnp(sub, sx, sy, dtype):
    x = _rand(jax.random.PRNGKey(1), sx, dtype)
    y = _rand(jax.random.PRNGKey(2), sy, dtype)
    got = dots.einsum(sub, x, y)
    ref = jnp.einsum(sub, x, y, precision="highest")
    assert got.dtype == ref.dtype and got.shape == ref.shape
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(got - ref))) <= RTOL[dtype] * scale


@pytest.mark.parametrize("dtype", [jnp.complex64, jnp.complex128])
def test_matmul_matches_jnp(dtype):
    u = fields.hot_start(LAT, 3, seed=3, dtype=dtype)
    ref = jnp.matmul(u, u, precision="highest")
    np.testing.assert_allclose(np.asarray(dots.matmul(u, u)), np.asarray(ref),
                               rtol=0, atol=RTOL[dtype] * 3)


def test_operators_lower_to_no_dot_general():
    """The hot operators are elementwise work: no dot_general for XLA:GPU
    to send to cuBLAS (where complex64 ran in TF32 and each D-slash
    became two dozen GEMM launches)."""
    u = apply_boundary_phases(fields.hot_start(LAT, 3, seed=5, dtype=jnp.complex64))
    psi = gaussian_spinor(jax.random.PRNGKey(6), LAT, 3, dtype=jnp.complex64)
    half = (LAT[0] // 2,) + LAT[1:]
    wd = WilsonDirac(kappa=0.13)
    sd = StaggeredDirac(mass=0.1, lattice=LAT)
    dd = DomainwallDirac(mass=0.1, m5=-1.0, l5=4)
    x_e = gaussian_spinor(jax.random.PRNGKey(7), half, 3, dtype=jnp.complex64)
    chi = gaussian_spinor(jax.random.PRNGKey(8), half, 3, nspin=1, dtype=jnp.complex64)
    phi5 = gaussian_spinor(jax.random.PRNGKey(9), (4,) + half, 3, dtype=jnp.complex64)
    programs = [
        (wd.apply, (u, psi)),
        (lambda uu, x: wd.apply_dhat_ddag(wd.packed_links(uu), x), (u, x_e)),
        (lambda uu, x: sd.apply_w_packed(sd.packed_links(uu), x), (u, chi)),
        (lambda uu, x: dd.apply_schur_ddag_d(dd.packed_links(uu), x), (u, phi5)),
        (lambda uu: ga.force(ga.wilson_gauge_action(3, 6.0), uu), (u,)),
    ]
    for fn, args in programs:
        assert "dot_general" not in jax.jit(fn).lower(*args).as_text()
