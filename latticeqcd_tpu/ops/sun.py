"""SU(N) matrix algebra on batched fields.

All functions operate on arrays whose *last two* axes are the color
(NC x NC) axes; any leading axes (direction, lattice sites) are batch
axes. This replaces the per-link mutable matrix objects of the
reference's Gaugefields.jl (link algebra surface reconstructed at
SURVEY.md section 2.4.1: exptU!, Traceless_antihermitian!, mul!, tr)
with pure batched jnp ops that XLA fuses and vectorizes.

Conventions
-----------
* Links U are SU(N): U @ dagger(U) = 1, det U = 1.
* Momenta are stored as *traceless hermitian* matrices H; the MD
  evolution is U <- exp(i eps H) U. The kinetic energy is tr(H^2),
  which equals (1/2) sum_a p_a^2 in a generator basis T_a with
  tr(T_a T_b) = delta_ab / 2 — matching the reference's momentum
  normalization (p*p/2 with NC^2-1 unit-variance coefficients,
  /root/reference/src/updates/standardHMC.jl:49,
  /root/reference/src/md/standardMD.jl:33).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from latticeqcd_tpu.ops import dots


def dagger(m: jnp.ndarray) -> jnp.ndarray:
    """Hermitian conjugate on the last two axes."""
    return jnp.conj(jnp.swapaxes(m, -1, -2))


def mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched matrix multiply on the last two axes."""
    return dots.matmul(a, b)


def trace(m: jnp.ndarray) -> jnp.ndarray:
    """Batched trace over the last two axes."""
    return jnp.trace(m, axis1=-2, axis2=-1)


def retrace(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.real(trace(m))


def eye_like(m: jnp.ndarray) -> jnp.ndarray:
    nc = m.shape[-1]
    return jnp.broadcast_to(jnp.eye(nc, dtype=m.dtype), m.shape)


def traceless_hermitian(m: jnp.ndarray) -> jnp.ndarray:
    """Project onto traceless hermitian matrices: (M + M†)/2 - tr/N.

    This is the momentum-space projection used by the MD force
    (counterpart of Traceless_antihermitian! up to the factor i;
    SURVEY.md 2.4.1, /root/reference/src/md/AbstractMD.jl:112).
    """
    nc = m.shape[-1]
    h = 0.5 * (m + dagger(m))
    tr = trace(h) / nc
    return h - tr[..., None, None] * jnp.eye(nc, dtype=m.dtype)


def traceless_antihermitian(m: jnp.ndarray) -> jnp.ndarray:
    """Project onto traceless antihermitian matrices: (M - M†)/2 - tr/N."""
    nc = m.shape[-1]
    a = 0.5 * (m - dagger(m))
    tr = trace(a) / nc
    return a - tr[..., None, None] * jnp.eye(nc, dtype=m.dtype)


def random_hermitian_momentum(key, shape_prefix, nc: int, dtype=jnp.complex128):
    """Draw traceless hermitian H with density exp(-tr H^2).

    Equivalent to drawing NC^2-1 coefficients p_a ~ N(0,1) in a basis
    with tr(T_a T_b) = delta_ab/2 (gauss_distribution! semantics,
    /root/reference/src/md/standardMD.jl:86). Construction: complex
    Ginibre A with entries CN(0,1), H = (A + A†)/2, then remove the
    trace (an orthogonal projection of the Gaussian).
    """
    rdtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    k1, k2 = jax.random.split(key)
    shape = tuple(shape_prefix) + (nc, nc)
    re = jax.random.normal(k1, shape, dtype=rdtype)
    im = jax.random.normal(k2, shape, dtype=rdtype)
    # float(...) keeps the scalar weakly typed: a NumPy f64 scalar here
    # silently promotes complex64 fields to complex128 under x64 mode
    a = (re + 1j * im).astype(dtype) / float(np.sqrt(2.0))
    h = 0.5 * (a + dagger(a))
    tr = trace(h) / nc
    return h - tr[..., None, None] * jnp.eye(nc, dtype=dtype)


def kinetic_energy(h: jnp.ndarray) -> jnp.ndarray:
    """tr(H^2) summed over all batch axes (= p.p/2 of the reference)."""
    return jnp.sum(jnp.real(trace(mul(h, h))))


# ---------------------------------------------------------------------------
# Matrix exponential of i * eps * H (H traceless hermitian)
# ---------------------------------------------------------------------------


def _expm_su2(x: jnp.ndarray) -> jnp.ndarray:
    """exp of a traceless antihermitian 2x2 matrix, analytically.

    x = i c . sigma  =>  exp(x) = cos|c| + i (c.sigma) sin|c|/|c|.
    """
    # x is traceless antihermitian: x = [[i a, b + i c], [-b + i c, -i a]]
    a = jnp.imag(x[..., 0, 0])
    b = jnp.real(x[..., 0, 1])
    c = jnp.imag(x[..., 0, 1])
    theta2 = a * a + b * b + c * c
    theta = jnp.sqrt(theta2)
    # sin(theta)/theta with a safe series for small theta
    small = theta < 1e-6
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    cost = jnp.cos(theta)
    e00 = cost + 1j * a * sinc
    e01 = (b + 1j * c) * sinc
    row0 = jnp.stack([e00, e01], axis=-1)
    row1 = jnp.stack([-jnp.conj(e01), jnp.conj(e00)], axis=-1)
    return jnp.stack([row0, row1], axis=-2).astype(x.dtype)


def _expi_su3_ch(h: jnp.ndarray, eps) -> jnp.ndarray:
    """exp(i Q) for traceless hermitian 3x3 Q = eps*H via the
    Cayley-Hamilton closed form (Morningstar-Peardon, hep-lat/0311018
    sec. III): exp(iQ) = f0 + f1 Q + f2 Q^2 with f_j from the
    eigenvalue parametrization

        c0 = det Q, c1 = tr(Q^2)/2,
        theta = arccos(|c0|/c0max), c0max = 2 (c1/3)^(3/2),
        u = sqrt(c1/3) cos(theta/3), w = sqrt(c1) sin(theta/3).

    With the |c0| reflection (f0 -> conj f0, f1 -> -conj f1,
    f2 -> conj f2 for c0 < 0) the denominator 9u^2 - w^2 >= 2 c1 is
    bounded away from zero except at Q -> 0, where a low-order Taylor
    (exact there) takes over. Costs 2 matmuls + elementwise math — the
    per-link MD hot path (SURVEY.md 7.4 "SU(3) exponential").
    """
    q = (eps * h).astype(h.dtype)
    rdt = jnp.float64 if h.dtype == jnp.complex128 else jnp.float32
    q2 = mul(q, q)
    c0 = jnp.real(jnp.linalg.det(q))
    c1 = 0.5 * jnp.real(trace(q2))

    small = c1 < 1e-8 if rdt == jnp.float64 else c1 < 1e-4
    c1s = jnp.where(small, 1.0, c1)  # keep sqrt/arccos well-defined

    c0max = 2.0 * (c1s / 3.0) ** 1.5
    sign = jnp.where(c0 < 0, -1.0, 1.0)
    ratio = jnp.clip(jnp.abs(c0) / c0max, 0.0, 1.0)
    theta = jnp.arccos(ratio)
    u = jnp.sqrt(c1s / 3.0) * jnp.cos(theta / 3.0)
    w = jnp.sqrt(c1s) * jnp.sin(theta / 3.0)

    u2 = u * u
    w2 = w * w
    # xi0 = sin(w)/w with a series guard
    wsmall = jnp.abs(w) < 0.05
    xi0 = jnp.where(
        wsmall,
        1.0 - w2 / 6.0 * (1.0 - w2 / 20.0 * (1.0 - w2 / 42.0)),
        jnp.sin(w) / jnp.where(wsmall, 1.0, w),
    )
    e2iu = jnp.exp(2j * u)
    emiu = jnp.exp(-1j * u)
    cosw = jnp.cos(w)
    h0 = (u2 - w2) * e2iu + emiu * (8.0 * u2 * cosw + 2j * u * (3.0 * u2 + w2) * xi0)
    h1 = 2.0 * u * e2iu - emiu * (2.0 * u * cosw - 1j * (3.0 * u2 - w2) * xi0)
    h2 = e2iu - emiu * (cosw + 3j * u * xi0)
    denom = 9.0 * u2 - w2
    denom = jnp.where(small, 1.0, denom)
    f0 = h0 / denom
    f1 = h1 / denom
    f2 = h2 / denom
    # c0 < 0 reflection: f_j(-c0) = (-1)^j conj(f_j(c0))
    f0 = jnp.where(sign < 0, jnp.conj(f0), f0)
    f1 = jnp.where(sign < 0, -jnp.conj(f1), f1)
    f2 = jnp.where(sign < 0, jnp.conj(f2), f2)

    ident = jnp.eye(3, dtype=h.dtype)
    out_ch = (
        f0[..., None, None] * ident
        + f1[..., None, None] * q
        + f2[..., None, None] * q2
    )
    # tiny-Q fallback: 4th-order Taylor of exp(iQ), exact as Q -> 0
    iq = 1j * q
    iq2 = mul(iq, iq)
    out_taylor = (
        ident
        + iq
        + iq2 / 2.0
        + mul(iq2, iq) / 6.0
        + mul(iq2, iq2) / 24.0
    )
    return jnp.where(small[..., None, None], out_taylor, out_ch)


_TAYLOR_ORDER = 10
_SCALING_SQUARINGS = 8


def _expm_taylor_ss(x: jnp.ndarray) -> jnp.ndarray:
    """Generic exp(X) by scaling-and-squaring with a Taylor core.

    Differentiable, shape-static, works for any NC. X is scaled by
    2^-k, expanded to order `_TAYLOR_ORDER` (Horner), then squared k
    times. For MD steps |X| = O(eps * |H|) is small, so the fixed
    k = 8 and order 10 give ~1e-16 relative accuracy for |X| <~ 20.
    """
    nc = x.shape[-1]
    scale = 2.0 ** (-_SCALING_SQUARINGS)
    xs = x * scale
    ident = jnp.eye(nc, dtype=x.dtype)
    acc = ident + xs / _TAYLOR_ORDER
    for k in range(_TAYLOR_ORDER - 1, 0, -1):
        acc = ident + mul(xs, acc) / k
    for _ in range(_SCALING_SQUARINGS):
        acc = mul(acc, acc)
    return acc


def expi_hermitian(h: jnp.ndarray, eps) -> jnp.ndarray:
    """exp(i * eps * H) for traceless hermitian H (batched).

    The counterpart of exptU! (SURVEY.md 2.4.1,
    /root/reference/src/md/AbstractMD.jl:90). su(2) uses the exact
    Pauli formula; other NC use scaling-and-squaring (an XLA-fused
    matmul chain).
    """
    if h.shape[-1] == 2:
        return _expm_su2(1j * eps * h)
    if h.shape[-1] == 3:
        return _expi_su3_ch(h, eps)
    return _expm_taylor_ss(1j * eps * h)


def expm_antihermitian(x: jnp.ndarray) -> jnp.ndarray:
    """exp(X) for traceless antihermitian X (batched); used by flow/stout."""
    if x.shape[-1] == 2:
        return _expm_su2(x)
    return _expm_taylor_ss(x)


# ---------------------------------------------------------------------------
# Group-manifold projection and random elements
# ---------------------------------------------------------------------------


def _np_project_sun(w: np.ndarray) -> np.ndarray:
    """Host-side projection of a stack of matrices onto SU(N) via QR."""
    q, r = np.linalg.qr(w)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    det = np.linalg.det(q)
    nc = w.shape[-1]
    q = q / (det ** (1.0 / nc))[..., None, None]
    return q


def random_sun_host(rng: np.random.Generator, shape_prefix, nc: int, dtype=np.complex128):
    """Haar-ish random SU(N) stack on the host (hot start).

    Counterpart of Initialize_Gaugefields(..., condition="hot")
    (SURVEY.md 2.4.1, /root/reference/src/system/universe.jl:41).
    """
    shape = tuple(shape_prefix) + (nc, nc)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return _np_project_sun(a).astype(dtype)


def unitarity_defect(u: jnp.ndarray) -> jnp.ndarray:
    """max |U U† - 1| over the batch: cheap health check for long runs."""
    nc = u.shape[-1]
    d = mul(u, dagger(u)) - jnp.eye(nc, dtype=u.dtype)
    return jnp.max(jnp.abs(d))


def reunitarize(u: jnp.ndarray) -> jnp.ndarray:
    """Project a near-SU(N) field back onto SU(N) (polar-like, via Newton).

    Uses the Newton iteration for the unitary polar factor
    W <- (W + (W†)^-1)/2 — but to stay inverse-free we use the
    Higham-style iteration W <- W (3 I - W† W)/2, valid for small
    defects, followed by a det-phase fix.
    """
    nc = u.shape[-1]
    w = u
    ident = jnp.eye(nc, dtype=u.dtype)
    for _ in range(3):
        w = mul(w, 1.5 * ident - 0.5 * mul(dagger(w), w))
    det = jnp.linalg.det(w)
    w = w / (det ** (1.0 / nc))[..., None, None]
    return w
