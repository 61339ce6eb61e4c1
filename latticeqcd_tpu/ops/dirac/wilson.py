"""Wilson Dirac operator (optionally clover-improved).

Counterpart of LatticeDiracOperators.jl's Wilson operator
(SURVEY.md 2.4.2; built from params kappa, r, boundarycondition at
/root/reference/src/system/universe.jl:111-137). Hopping form:

    D psi(x) = psi(x)
      - kappa sum_mu [ (r - g_mu) U_mu(x) psi(x+mu)
                     + (r + g_mu) U_mu(x-mu)^dag psi(x-mu) ]

with boundary phases (default antiperiodic time, bc = [1,1,1,-1],
system_parameters.jl:52) absorbed into the links. Spinor layout:
psi[X, Y, Z, T, 4(spin), NC]. The hopping term contracts color with
a batched 3x3 mat-vec and spin with the 8 fixed 4x4 projectors —
pure einsum chains that XLA fuses into one pass over the field; on a
sharded mesh the shifts become halo collective-permutes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from latticeqcd_tpu.ops.dirac import eo_pack, gammas

from latticeqcd_tpu.ops import dots, rolls

DIRS = 4


def apply_boundary_phases(u: jnp.ndarray, bc=(1, 1, 1, -1)) -> jnp.ndarray:
    """Multiply the last time-slice (and analogous) links by the
    boundary phase so plain periodic shifts implement the fermion BCs."""
    for mu, phase in enumerate(bc):
        if phase == 1:
            continue
        l = u.shape[1 + mu]
        idx = [slice(None)] * u.ndim
        idx[1 + mu] = l - 1
        u = u.at[mu].set(u[mu].at[tuple(idx[1:])].multiply(phase))
    return u


def _shift(f, mu, steps):
    return rolls.roll(f, -steps, axis=mu)


@dataclass(frozen=True)
class WilsonDirac:
    """Static description of a Wilson operator: D(U) psi."""

    kappa: float
    r: float = 1.0
    bc: tuple = (1, 1, 1, -1)
    csw: float = 0.0  # clover coefficient (Clover term, system_parameters.jl:87)

    def apply(self, u: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
        """D psi. u must already carry boundary phases
        (apply_boundary_phases) — the driver layer does this once.

        At r=1 the hopping term uses the half-spinor projection
        (1 -+ g_mu) = 2 V V^dag: project spin 4 -> 2, color-multiply
        the half spinor, reconstruct — half the color flops of the
        naive form (SURVEY.md 7.2 M3 "fused stencil")."""
        if self.r == 1.0:
            hop = self._hop_half_spinor(u, psi)
        else:
            hop = self._hop_generic(u, psi)
        out = psi - self.kappa * hop
        if self.csw != 0.0:
            out = out + self._clover_term(u, psi)
        return out

    def _hop_generic(self, u, psi):
        pm, pp = gammas.projectors(self.r)
        pm = jnp.asarray(pm, dtype=psi.dtype)
        pp = jnp.asarray(pp, dtype=psi.dtype)
        hop = 0.0
        for mu in range(DIRS):
            umu = u[mu]
            fwd = dots.einsum("...ab,...sb->...sa", umu, _shift(psi, mu, +1))
            bwd = dots.einsum(
                "...ba,...sb->...sa", jnp.conj(_shift(umu, mu, -1)), _shift(psi, mu, -1)
            )
            hop = hop + dots.einsum("st,...tc->...sc", pm[mu], fwd)
            hop = hop + dots.einsum("st,...tc->...sc", pp[mu], bwd)
        return hop

    def _hop_half_spinor(self, u, psi):
        vm, vp = gammas.half_spinor_factors()
        vm = jnp.asarray(vm, dtype=psi.dtype)
        vp = jnp.asarray(vp, dtype=psi.dtype)
        hop = 0.0
        for mu in range(DIRS):
            umu = u[mu]
            # forward: 2 Vm [ U (Vm^dag psi)(x+mu) ]
            half = dots.einsum("sh,...sc->...hc", jnp.conj(vm[mu]), _shift(psi, mu, +1))
            half = dots.einsum("...ab,...hb->...ha", umu, half)
            hop = hop + 2.0 * dots.einsum("sh,...hc->...sc", vm[mu], half)
            # backward: 2 Vp [ U^dag(x-mu) (Vp^dag psi)(x-mu) ]
            half = dots.einsum("sh,...sc->...hc", jnp.conj(vp[mu]), _shift(psi, mu, -1))
            half = dots.einsum(
                "...ba,...hb->...ha", jnp.conj(_shift(umu, mu, -1)), half
            )
            hop = hop + 2.0 * dots.einsum("sh,...hc->...sc", vp[mu], half)
        return hop

    def apply_dagger(self, u: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
        """D^dag psi = g5 D g5 psi (gamma5-hermiticity)."""
        g5 = jnp.asarray(np.diag(gammas.GAMMA5).real, dtype=psi.dtype)
        psi5 = psi * g5[:, None]
        return self.apply(u, psi5) * g5[:, None]

    # ------------------------------------------------------------------
    # Even-odd preconditioning (packed layout, ops/dirac/eo_pack.py)
    #
    # D = [[1, -kappa H_eo], [-kappa H_oe, 1]] for csw=0, so
    # det D = det(Dhat) with the Schur complement on even sites
    #     Dhat = 1 - kappa^2 H_eo H_oe,
    # and the solver/HMC hot loop runs on V/2-site packed fields with
    # a better-conditioned operator (the reference keeps the analogous
    # even-odd solvers inside LatticeDiracOperators.jl, SURVEY.md 2.5).
    # ------------------------------------------------------------------

    def packed_links(self, u: jnp.ndarray):
        lattice = u.shape[1:5]
        return eo_pack.pack_links(u, lattice)

    def hop_packed(self, u_t, u_s, psi_s, target_parity: int) -> jnp.ndarray:
        """Hopping term H psi on target-parity sites; psi lives on the
        source parity (packed layout). Half-spinor form at r=1."""
        x2 = psi_s.shape[0]
        lattice = (2 * x2,) + tuple(psi_s.shape[1:4])
        s_t = eo_pack.offset_field(lattice, target_parity)
        hop = 0.0
        if self.r == 1.0:
            vm, vp = gammas.half_spinor_factors()
            vm = jnp.asarray(vm, dtype=psi_s.dtype)
            vp = jnp.asarray(vp, dtype=psi_s.dtype)
            for mu in range(DIRS):
                half = dots.einsum("sh,...sc->...hc", jnp.conj(vm[mu]),
                                  eo_pack.gather_plus(psi_s, mu, s_t))
                half = dots.einsum("...ab,...hb->...ha", u_t[mu], half)
                hop = hop + 2.0 * dots.einsum("sh,...hc->...sc", vm[mu], half)
                half = dots.einsum("sh,...sc->...hc", jnp.conj(vp[mu]),
                                  eo_pack.gather_minus(psi_s, mu, s_t))
                u_m = eo_pack.gather_minus(u_s[mu], mu, s_t)
                half = dots.einsum("...ba,...hb->...ha", jnp.conj(u_m), half)
                hop = hop + 2.0 * dots.einsum("sh,...hc->...sc", vp[mu], half)
            return hop
        pm, pp = gammas.projectors(self.r)
        pm = jnp.asarray(pm, dtype=psi_s.dtype)
        pp = jnp.asarray(pp, dtype=psi_s.dtype)
        for mu in range(DIRS):
            fwd = dots.einsum("...ab,...sb->...sa", u_t[mu],
                             eo_pack.gather_plus(psi_s, mu, s_t))
            u_m = eo_pack.gather_minus(u_s[mu], mu, s_t)
            bwd = dots.einsum("...ba,...sb->...sa", jnp.conj(u_m),
                             eo_pack.gather_minus(psi_s, mu, s_t))
            hop = hop + dots.einsum("st,...tc->...sc", pm[mu], fwd)
            hop = hop + dots.einsum("st,...tc->...sc", pp[mu], bwd)
        return hop

    def apply_dhat(self, u_eo, x_e: jnp.ndarray) -> jnp.ndarray:
        """Dhat x = x - kappa^2 H_eo H_oe x on packed even fields.
        Valid for csw=0 only (clover adds a parity-diagonal block)."""
        u_e, u_o = u_eo
        d1 = self.hop_packed(u_o, u_e, x_e, target_parity=1)
        d2 = self.hop_packed(u_e, u_o, d1, target_parity=0)
        return x_e - self.kappa ** 2 * d2

    def apply_dhat_dagger(self, u_eo, x_e: jnp.ndarray) -> jnp.ndarray:
        """Dhat^dag = g5 Dhat g5 (gamma5-hermiticity survives the Schur
        complement: g5 H_eo g5 = H_oe^dag blockwise)."""
        g5 = jnp.asarray(np.diag(gammas.GAMMA5).real, dtype=x_e.dtype)
        return self.apply_dhat(u_eo, x_e * g5[:, None]) * g5[:, None]

    def apply_dhat_ddag(self, u_eo, x_e: jnp.ndarray) -> jnp.ndarray:
        return self.apply_dhat(u_eo, self.apply_dhat_dagger(u_eo, x_e))

    def apply_ddag_d(self, u, psi):
        return self.apply_dagger(u, self.apply(u, psi))

    def apply_d_ddag(self, u, psi):
        return self.apply(u, self.apply_dagger(u, psi))

    # ------------------------------------------- clover even-odd Schur
    def clover_site_matrix(self, u):
        """The parity-diagonal clover block as explicit site matrices:
        A(x)[s,a,t,b] with A = 1 + T, T psi = -(csw kappa/2)
        sigma_munu F_munu psi. Site-local (no hops), so even-odd
        preconditioning factorizes D = [[A_ee, -kH_eo],[-kH_oe, A_oo]]
        and the measurement solves run on the half-volume Schur
        complement Dhat = A_ee - k^2 H_eo A_oo^-1 H_oe."""
        from latticeqcd_tpu.ops import sun
        from latticeqcd_tpu.ops.wilsonline import evaluate_line, make_cloverloops

        nc = u.shape[-1]
        sigma = np.zeros((4, 4, 4, 4), dtype=np.complex128)
        for mu in range(4):
            for nu in range(4):
                sigma[mu, nu] = (
                    (gammas.GAMMA[mu] @ gammas.GAMMA[nu]
                     - gammas.GAMMA[nu] @ gammas.GAMMA[mu]) / 2.0
                )
        t = 0.0
        for mu in range(4):
            for nu in range(4):
                if mu == nu:
                    continue
                clov = 0.0
                for line in make_cloverloops(mu, nu):
                    clov = clov + evaluate_line(u, line)
                f = sun.traceless_antihermitian(clov) / 4.0
                smat = jnp.asarray(sigma[mu, nu], dtype=u.dtype)
                t = t + dots.einsum("st,...ab->...satb", smat, f)
        eye = jnp.eye(4 * nc, dtype=u.dtype).reshape(4, nc, 4, nc)
        return eye - (self.csw * self.kappa / 2.0) * t

    def clover_packed_blocks(self, up):
        """(a_e, ainv_o): even-parity clover block and INVERSE odd
        block, packed (ops/dirac/eo_pack.py layout). The batched 12x12
        inversions run once per link configuration and are amortized
        over every CG iteration of every right-hand side."""
        from latticeqcd_tpu.ops.dirac import eo_pack

        lattice = tuple(up.shape[1:5])
        a = self.clover_site_matrix(up)
        a_e = eo_pack.pack(a, lattice, 0)
        a_o = eo_pack.pack(a, lattice, 1)
        n = a_o.shape[-3] * a_o.shape[-2]  # 4 * nc
        ainv_o = jnp.linalg.inv(a_o.reshape(a_o.shape[:-4] + (n, n))).reshape(
            a_o.shape
        )
        return a_e, ainv_o

    @staticmethod
    def site_apply(a, x):
        """y[s,a] = A[s,a,t,b] x[t,b] per site."""
        return dots.einsum("...satb,...tb->...sa", a, x)

    def apply_dhat_clover(self, u_eo, a_e, ainv_o, x_e):
        """Dhat x_e = A_ee x_e - k^2 H_eo A_oo^-1 H_oe x_e."""
        u_e, u_o = u_eo
        t = self.hop_packed(u_o, u_e, x_e, target_parity=1)
        t = self.site_apply(ainv_o, t)
        t = self.hop_packed(u_e, u_o, t, target_parity=0)
        return self.site_apply(a_e, x_e) - (self.kappa ** 2) * t

    def apply_dhat_clover_dagger(self, u_eo, a_e, ainv_o, x_e):
        """Dhat^dag = g5 Dhat g5 (clover and hopping are both
        gamma5-hermitian, so the Schur complement inherits it)."""
        g5 = jnp.asarray(gammas.GAMMA5, dtype=x_e.dtype)
        gx = dots.einsum("st,...tc->...sc", g5, x_e)
        y = self.apply_dhat_clover(u_eo, a_e, ainv_o, gx)
        return dots.einsum("st,...tc->...sc", g5, y)

    # ------------------------------------------------------------------
    def _clover_term(self, u, psi):
        """-(csw kappa / 2) sigma_munu F_munu psi with clover-leaf F."""
        from latticeqcd_tpu.ops import sun
        from latticeqcd_tpu.ops.wilsonline import evaluate_line, make_cloverloops

        sigma = np.zeros((4, 4, 4, 4), dtype=np.complex128)
        for mu in range(4):
            for nu in range(4):
                sigma[mu, nu] = (
                    (gammas.GAMMA[mu] @ gammas.GAMMA[nu] - gammas.GAMMA[nu] @ gammas.GAMMA[mu])
                    / 2.0
                )
        acc = 0.0
        for mu in range(4):
            for nu in range(4):
                if mu == nu:
                    continue
                clov = 0.0
                for line in make_cloverloops(mu, nu):
                    clov = clov + evaluate_line(u, line)
                f = sun.traceless_antihermitian(clov) / 4.0  # (1/8)(C - C^dag) w/ 4 leaves
                smat = jnp.asarray(sigma[mu, nu], dtype=psi.dtype)
                fpsi = dots.einsum("...ab,...sb->...sa", f, psi)
                acc = acc + dots.einsum("st,...tc->...sc", smat, fpsi)
        return -(self.csw * self.kappa / 2.0) * acc


def gaussian_spinor(key, lattice, nc, nspin=4, dtype=jnp.complex128):
    """Unit-variance complex Gaussian spinor: E|psi_i|^2 = 1."""
    rdtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    k1, k2 = jax.random.split(key)
    shape = tuple(lattice) + ((nspin, nc) if nspin > 1 else (nc,))
    re = jax.random.normal(k1, shape, dtype=rdtype)
    im = jax.random.normal(k2, shape, dtype=rdtype)
    return ((re + 1j * im) / np.sqrt(2.0)).astype(dtype)


def z4_spinor(key, lattice, nc, nspin=4, dtype=jnp.complex128):
    """Z4 noise: entries in {1, i, -1, -i}/1 (Z4_distribution_fermi!
    semantics, SURVEY.md 2.4.2)."""
    shape = tuple(lattice) + ((nspin, nc) if nspin > 1 else (nc,))
    k = jax.random.randint(key, shape, 0, 4)
    vals = jnp.stack(
        [jnp.ones(shape), 1j * jnp.ones(shape), -jnp.ones(shape), -1j * jnp.ones(shape)]
    )
    return jnp.take_along_axis(vals, k[None], axis=0)[0].astype(dtype)


def inner(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Global <a, b> = sum conj(a) b (the reference's dot(a,b)).

    Elementwise form, NOT jnp.vdot: vdot's ravel forces the GSPMD
    partitioner to all-gather the full sharded field before the dot
    (ops/solvers.py _vdot note); this form stays sharded and reduces
    to a scalar all-reduce."""
    return jnp.sum(jnp.conj(a) * b)
