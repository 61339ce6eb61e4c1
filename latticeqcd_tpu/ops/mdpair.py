"""Mixed-precision MD state: complex fields as float64 (re, im) pairs.

Why this exists (VERDICT r4 weak #2 / next #3): the round-4 bias study
(PERF.md "complex64 sampling-bias evidence") measured a real
+0.078 +- 0.026 dH offset and ~18 pp acceptance loss at 8^4 in the
production complex64 dtype, localized *by elimination* to c64 rounding
in the integrator arithmetic itself — the exp(i eps H) U products and
the kick accumulation h += eps*F — after link-unitarity drift and
force/solver precision were ruled out by direct experiment. The fix is
to run ONLY the integrator state (U, H) and its updates in f64 while
every expensive term (gauge/fermion forces, CG solves, action
evaluations, the links handed to the next trajectory) stays complex64.

Representation: a `PairField` carries (re, im) float64 arrays plus
the complex dtype it lowers back to, registered as a pytree so it
flows through `jax.jit` / `lax.fori_loop` carries unchanged. All pair
arithmetic (matmul, scale, add, the exponential map) is expressed in
real f64 ops and no complex128 array is ever built. Whether holding
the state as complex128 instead is as fast and as simple is an open
measurement (ROADMAP.md).

Requires jax_enable_x64 (else the "f64" pair silently truncates to
f32 and buys nothing) — callers must check `require_x64()`.

Cost model: the pair exponential is the generic Taylor +
scaling-and-squaring scheme of ops/sun._expm_taylor_ss (order 10,
8 squarings, ~1e-16 relative for |eps*H| <~ 20) at 4 real matmuls per
complex matmul — ~70 real [3,3] matmuls per link update. That is noise
next to a single fermion-force CG (hundreds of D-slash applications),
which is why the measured wall-clock overhead target is ~10%
(VERDICT r4 next #3 "Done" criterion; measured numbers in PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from latticeqcd_tpu.ops import dots


@jax.tree_util.register_pytree_node_class
class PairField:
    """A complex field stored as float64 (re, im), lowering to cdtype.

    Supports the only algebra the MD integrators apply to state:
    PairField + PairField, PairField + complex_array (a kick increment,
    upcast exactly to f64), and real_scalar * PairField. Everything
    else must go through the module functions.
    """

    __slots__ = ("re", "im", "cdtype")

    def __init__(self, re, im, cdtype):
        self.re = re
        self.im = im
        self.cdtype = jnp.dtype(cdtype)

    def tree_flatten(self):
        return (self.re, self.im), str(self.cdtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)

    # --- the (only) operators integrator bodies use on MD state
    def __add__(self, other):
        if isinstance(other, PairField):
            return PairField(self.re + other.re, self.im + other.im, self.cdtype)
        # kick increment: a complex (c64) force array; the upcast to
        # f64 is exact, the accumulation into the large H happens here
        # in f64 — this is the compensated-kick half of the fix
        re = self.re + jnp.real(other).astype(self.re.dtype)
        im = self.im + jnp.imag(other).astype(self.im.dtype)
        return PairField(re, im, self.cdtype)

    __radd__ = __add__

    def __mul__(self, s):
        return PairField(self.re * s, self.im * s, self.cdtype)

    __rmul__ = __mul__

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):  # the complex dtype this lowers to
        return self.cdtype


def require_x64() -> None:
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "md_precision='mixed' needs jax_enable_x64=True; without it the "
            "f64 pair state silently truncates to f32 and mitigates nothing"
        )


def lift(x: jnp.ndarray) -> PairField:
    """Complex array -> f64 pair (exact)."""
    f64 = jnp.float64
    return PairField(jnp.real(x).astype(f64), jnp.imag(x).astype(f64), x.dtype)


def lower(p: PairField) -> jnp.ndarray:
    """f64 pair -> the original complex dtype.

    Builds complex64 via lax.complex on downcast f32 parts — never
    materializing a complex128 array.
    """
    if p.cdtype == jnp.complex64:
        return jax.lax.complex(p.re.astype(jnp.float32), p.im.astype(jnp.float32))
    return jax.lax.complex(p.re, p.im)


def as_complex(x):
    """Polymorphic view for force/action evaluation: lower pairs,
    pass complex arrays through."""
    return lower(x) if isinstance(x, PairField) else x


def matmul(a: PairField, b: PairField) -> PairField:
    """Batched complex matmul in real-pair arithmetic (4 real matmuls)."""
    re = dots.matmul(a.re, b.re) - dots.matmul(a.im, b.im)
    im = dots.matmul(a.re, b.im) + dots.matmul(a.im, b.re)
    return PairField(re, im, a.cdtype)


_TAYLOR_ORDER = 10
_SCALING_SQUARINGS = 8


def _expi_taylor_ss(h: PairField, eps) -> PairField:
    """Generic-NC exp(i*eps*H) (mirrors sun._expm_taylor_ss).

    X = i*eps*H has re = -eps*H_im, im = eps*H_re (a pure swap/scale).
    Fixed order-10 Taylor after 8 halvings: ~1e-16 relative for
    |eps*H| <~ 20, far beyond any MD step size.
    """
    scale = 2.0 ** (-_SCALING_SQUARINGS)
    xr = (-eps * scale) * h.im
    xi = (eps * scale) * h.re
    x = PairField(xr, xi, h.cdtype)
    nc = h.re.shape[-1]
    ident = jnp.eye(nc, dtype=jnp.float64)
    acc = PairField(ident + xr / _TAYLOR_ORDER, xi / _TAYLOR_ORDER, h.cdtype)
    for k in range(_TAYLOR_ORDER - 1, 0, -1):
        m = matmul(x, acc)
        acc = PairField(ident + m.re / k, m.im / k, h.cdtype)
    for _ in range(_SCALING_SQUARINGS):
        acc = matmul(acc, acc)
    return acc


def _cmul(a, b):
    """Elementwise complex multiply on (re, im) array tuples."""
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _expi_su3_ch(h: PairField, eps) -> PairField:
    """exp(i*eps*H) for 3x3 hermitian H: the Cayley-Hamilton closed
    form of sun._expi_su3_ch transcribed into real-pair f64 arithmetic.

    2 pair matmuls (q^2 + the always-computed tiny-Q Taylor fallback's
    three) + real scalar trig per site — ~3.5x fewer matmuls than the
    generic Taylor/scaling-squaring path, which measured as a 2.1x
    wall overhead on a cheap-solve dynamical workload (PERF.md
    mixed-MD cost table). The complex scalars f0..f2 and e^{2iu},
    e^{-iu} live as (re, im) f64 pairs; no complex128 array is ever
    built."""
    qr, qi = eps * h.re, eps * h.im
    q2 = matmul(PairField(qr, qi, h.cdtype), PairField(qr, qi, h.cdtype))
    # det(Q) is real for hermitian Q; expand along the first row, in
    # pair arithmetic, then keep the real part
    m00 = _cmul((qr[..., 1, 1], qi[..., 1, 1]), (qr[..., 2, 2], qi[..., 2, 2]))
    m01 = _cmul((qr[..., 1, 2], qi[..., 1, 2]), (qr[..., 2, 1], qi[..., 2, 1]))
    m10 = _cmul((qr[..., 1, 0], qi[..., 1, 0]), (qr[..., 2, 2], qi[..., 2, 2]))
    m12 = _cmul((qr[..., 1, 2], qi[..., 1, 2]), (qr[..., 2, 0], qi[..., 2, 0]))
    m20 = _cmul((qr[..., 1, 0], qi[..., 1, 0]), (qr[..., 2, 1], qi[..., 2, 1]))
    m21 = _cmul((qr[..., 1, 1], qi[..., 1, 1]), (qr[..., 2, 0], qi[..., 2, 0]))
    c00 = (m00[0] - m01[0], m00[1] - m01[1])
    c01 = (m10[0] - m12[0], m10[1] - m12[1])
    c02 = (m20[0] - m21[0], m20[1] - m21[1])
    d0 = _cmul((qr[..., 0, 0], qi[..., 0, 0]), c00)
    d1 = _cmul((qr[..., 0, 1], qi[..., 0, 1]), c01)
    d2 = _cmul((qr[..., 0, 2], qi[..., 0, 2]), c02)
    c0 = d0[0] - d1[0] + d2[0]
    c1 = 0.5 * (q2.re[..., 0, 0] + q2.re[..., 1, 1] + q2.re[..., 2, 2])

    small = c1 < 1e-8
    c1s = jnp.where(small, 1.0, c1)
    c0max = 2.0 * (c1s / 3.0) ** 1.5
    sign = jnp.where(c0 < 0, -1.0, 1.0)
    ratio = jnp.clip(jnp.abs(c0) / c0max, 0.0, 1.0)
    theta = jnp.arccos(ratio)
    u = jnp.sqrt(c1s / 3.0) * jnp.cos(theta / 3.0)
    w = jnp.sqrt(c1s) * jnp.sin(theta / 3.0)
    u2, w2 = u * u, w * w
    wsmall = jnp.abs(w) < 0.05
    xi0 = jnp.where(
        wsmall,
        1.0 - w2 / 6.0 * (1.0 - w2 / 20.0 * (1.0 - w2 / 42.0)),
        jnp.sin(w) / jnp.where(wsmall, 1.0, w),
    )
    cosw = jnp.cos(w)
    e2iu = (jnp.cos(2.0 * u), jnp.sin(2.0 * u))
    emiu = (jnp.cos(u), -jnp.sin(u))
    # h0 = (u2-w2) e2iu + emiu (8 u2 cosw + 2i u (3 u2 + w2) xi0)
    b0 = (8.0 * u2 * cosw, 2.0 * u * (3.0 * u2 + w2) * xi0)
    h0 = tuple((u2 - w2) * e + x for e, x in zip(e2iu, _cmul(emiu, b0)))
    # h1 = 2 u e2iu - emiu (2 u cosw - i (3 u2 - w2) xi0)
    b1 = (2.0 * u * cosw, -(3.0 * u2 - w2) * xi0)
    h1 = tuple(2.0 * u * e - x for e, x in zip(e2iu, _cmul(emiu, b1)))
    # h2 = e2iu - emiu (cosw + 3 i u xi0)
    b2 = (cosw, 3.0 * u * xi0)
    h2 = tuple(e - x for e, x in zip(e2iu, _cmul(emiu, b2)))
    denom = jnp.where(small, 1.0, 9.0 * u2 - w2)
    f0 = (h0[0] / denom, h0[1] / denom)
    f1 = (h1[0] / denom, h1[1] / denom)
    f2 = (h2[0] / denom, h2[1] / denom)
    # c0 < 0 reflection: f_j(-c0) = (-1)^j conj(f_j(c0))
    neg = sign < 0
    f0 = (f0[0], jnp.where(neg, -f0[1], f0[1]))
    f1 = (jnp.where(neg, -f1[0], f1[0]), f1[1])
    f2 = (f2[0], jnp.where(neg, -f2[1], f2[1]))

    ident = jnp.eye(3, dtype=jnp.float64)
    def _sc(f, mr, mi):  # complex scalar field * pair matrix
        fr, fi = f[0][..., None, None], f[1][..., None, None]
        return fr * mr - fi * mi, fr * mi + fi * mr
    o0 = _sc(f0, ident, jnp.zeros_like(ident))
    o1 = _sc(f1, qr, qi)
    o2 = _sc(f2, q2.re, q2.im)
    out_r = o0[0] + o1[0] + o2[0]
    out_i = o0[1] + o1[1] + o2[1]
    # tiny-Q fallback: 4th-order Taylor of exp(iQ) (exact as Q -> 0)
    iq = PairField(-qi, qr, h.cdtype)
    iq2 = matmul(iq, iq)
    iq3 = matmul(iq2, iq)
    iq4 = matmul(iq2, iq2)
    t_r = jnp.eye(3, dtype=jnp.float64) + iq.re + iq2.re / 2.0 + iq3.re / 6.0 + iq4.re / 24.0
    t_i = iq.im + iq2.im / 2.0 + iq3.im / 6.0 + iq4.im / 24.0
    sm = small[..., None, None]
    return PairField(jnp.where(sm, t_r, out_r), jnp.where(sm, t_i, out_i),
                     h.cdtype)


def expi_hermitian(h: PairField, eps) -> PairField:
    """exp(i * eps * H) in pair arithmetic: Cayley-Hamilton closed form
    for the production SU(3) case, Taylor + scaling-and-squaring for
    generic NC (both match sun.expi_hermitian at ~1e-13)."""
    if h.re.shape[-1] == 3:
        return _expi_su3_ch(h, eps)
    return _expi_taylor_ss(h, eps)


def update_links(u: PairField, h: PairField, eps) -> PairField:
    """U <- exp(i eps H) U, fully in f64 pair arithmetic."""
    return matmul(expi_hermitian(h, eps), u)


def kinetic_energy(h: PairField) -> jnp.ndarray:
    """tr(H^2) summed over batch axes, f64. For hermitian H this equals
    sum |H_ij|^2 = sum (re^2 + im^2), matching sun.kinetic_energy."""
    return jnp.sum(h.re * h.re) + jnp.sum(h.im * h.im)
