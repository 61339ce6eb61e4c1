"""Standard (Shamir) domain-wall Dirac operator.

Counterpart of LatticeDiracOperators.jl's "Domainwall" operator
(SURVEY.md 2.4.2; params M, m, L5 at
/root/reference/src/system/universe.jl:118-128; reference test uses
M=-1, m=1, L5=4 on 4x4x2x2, test/test_domainwallhmc.toml). 5D field
psi[L5, X, Y, Z, T, 4, NC]; the L5 axis is purely local (never
sharded, SURVEY.md 7.4).

    (D_dw psi)_s = [D_w4(M) + 1] psi_s - P- psi_{s+1} - P+ psi_{s-1}

with P+- = (1 +- g5)/2 and chiral boundaries carrying the physical
mass m:  psi_{L5} -> -m psi_0 (P- branch), psi_{-1} -> -m psi_{L5-1}
(P+ branch). D_w4(M) is the 4D Wilson operator with bare mass M
(diagonal 4r + M). The adjoint is EXPLICIT (projector swap for the
hop, chiral-matrix swap for the L5 block — see apply_dagger) and
pinned against jax.linear_transpose, whose transposed rolls lower to
halo-plane all-reduces under GSPMD.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from latticeqcd_tpu.ops.dirac import gammas

from latticeqcd_tpu.ops import dots, rolls

DIRS = 4


def _shift4(f, mu, steps):
    """Shift on the 4D site axes of a 5D spinor (axes 1..4)."""
    return rolls.roll(f, -steps, axis=1 + mu)


@dataclass(frozen=True)
class DomainwallDirac:
    """D_dw(m) with height M and extent L5."""

    mass: float  # physical (boundary) mass m
    m5: float  # domain-wall height M (reference Domainwall_M)
    l5: int
    r: float = 1.0
    bc: tuple = (1, 1, 1, -1)

    def _wilson4(self, u, psi, dag: bool = False):
        """(4r + M) - (1/2) sum_mu [(r-g)U T+ + (r+g)U^dag T-] on each s.

        dag=True applies the ADJOINT of the hop: with gamma_mu
        hermitian and r real, (r -+ gamma) are hermitian, so the
        adjoint is the SAME stencil with the two projectors swapped
        (forward hop carries r+gamma, backward r-gamma) — no
        linear_transpose, whose transposed jnp.roll lowers to a pad +
        halo-plane ALL-REDUCE under GSPMD instead of a permute
        (caught by tests/test_collective_audit.py)."""
        pm, pp = gammas.projectors(self.r)
        if dag:
            pm, pp = pp, pm
        pm = jnp.asarray(pm, dtype=psi.dtype)
        pp = jnp.asarray(pp, dtype=psi.dtype)
        out = (4.0 * self.r + self.m5) * psi
        hop = 0.0
        for mu in range(DIRS):
            umu = u[mu]  # (X,Y,Z,T,a,b) broadcasts over the leading L5 axis
            fwd = dots.einsum("...ab,l...sb->l...sa", umu, _shift4(psi, mu, +1))
            bwd = dots.einsum(
                "...ba,l...sb->l...sa",
                jnp.conj(rolls.roll(umu, 1, axis=mu)),
                _shift4(psi, mu, -1),
            )
            hop = hop + dots.einsum("st,l...tc->l...sc", pm[mu], fwd)
            hop = hop + dots.einsum("st,l...tc->l...sc", pp[mu], bwd)
        return out - 0.5 * hop

    def apply(self, u: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
        """D_dw(m) psi for psi[L5, X, Y, Z, T, 4, NC]."""
        # dtype pinned: a default (f64 under x64) asarray here promotes
        # complex64 fields to complex128 through the broadcasts below
        rdt = jnp.float64 if psi.dtype == jnp.complex128 else jnp.float32
        g5 = jnp.asarray(np.diag(gammas.GAMMA5).real, dtype=rdt)
        p_minus = (1.0 - g5) / 2.0  # acts on spin axis diagonally
        p_plus = (1.0 + g5) / 2.0

        out = self._wilson4(u, psi) + psi

        # psi_{s+1} with boundary psi_{L5} = -m psi_0
        up = jnp.roll(psi, -1, axis=0)
        up = up.at[self.l5 - 1].set(-self.mass * psi[0])
        # psi_{s-1} with boundary psi_{-1} = -m psi_{L5-1}
        dn = jnp.roll(psi, 1, axis=0)
        dn = dn.at[0].set(-self.mass * psi[self.l5 - 1])

        out = out - p_minus[:, None] * up - p_plus[:, None] * dn
        return out

    def apply_dagger(self, u: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
        """Explicit adjoint (pinned against jax.linear_transpose in
        tests/test_domainwall.py): the 4D hop adjoint swaps the
        projectors (_wilson4 dag note), and for the L5 couplings
        (P-+ S+-m)^dag = P-+ S-+m — the s-shift matrices are real with
        S+m^T = S-m (the -m corners transpose onto each other), so the
        adjoint just swaps which chirality rides which shift."""
        rdt = jnp.float64 if psi.dtype == jnp.complex128 else jnp.float32
        g5 = jnp.asarray(np.diag(gammas.GAMMA5).real, dtype=rdt)
        p_minus = (1.0 - g5) / 2.0
        p_plus = (1.0 + g5) / 2.0

        out = self._wilson4(u, psi, dag=True) + psi
        up = jnp.roll(psi, -1, axis=0)
        up = up.at[self.l5 - 1].set(-self.mass * psi[0])
        dn = jnp.roll(psi, 1, axis=0)
        dn = dn.at[0].set(-self.mass * psi[self.l5 - 1])
        # D has -P- up - P+ dn; the adjoint swaps the chiralities
        return out - p_plus[:, None] * up - p_minus[:, None] * dn

    def apply_ddag_d(self, u, psi):
        return self.apply_dagger(u, self.apply(u, psi))

    # ------------------------------------------------------------------
    # 4D-checkerboard (even-odd) Schur preconditioning (VERDICT r3
    # weak #5). The 5D operator splits by 4D site parity as
    #
    #     D = [[A, B_eo], [B_oe, A]],   det D = det(A) det(Shat),
    #     Shat = A - B_eo A^-1 B_oe,
    #
    # where B is the (mass-independent) 4D Wilson hop and A collects
    # everything 4D-site-local: the diagonal (4r + M + 1) and the L5
    # couplings -P- psi_{s+1} - P+ psi_{s-1} with the mass boundaries.
    # A carries NO link dependence, so det(A) is a constant of the
    # gauge field and the U-dependent part of det D is det(Shat) —
    # pseudofermions can live on half-volume PACKED even fields with
    # the better-conditioned Shat, exactly as the Wilson Dhat path
    # (fermion_action.py WilsonFermiAction). The L5 axis stays local
    # (SURVEY.md 7.4): A^-1 is a pair of precomputed L5 x L5 matrices
    # (one per chirality, since A = P+ (d - S-) + P- (d - S+) with
    # diagonal gamma5), applied as a site-local einsum — no solver
    # inside the operator.
    # ------------------------------------------------------------------

    def _chiral_masks(self, psi):
        """(P+, P-) as (...,4,1)-broadcastable diagonal spin masks."""
        rdt = jnp.float64 if psi.dtype == jnp.complex128 else jnp.float32
        g5 = np.diag(gammas.GAMMA5).real
        shape = (1,) * (psi.ndim - 2) + (4, 1)
        pp = jnp.asarray(((1.0 + g5) / 2.0).reshape(shape), dtype=rdt)
        pm = jnp.asarray(((1.0 - g5) / 2.0).reshape(shape), dtype=rdt)
        return pp, pm

    def _a_mats(self):
        """(A+, A-) as numpy L5 x L5: A+- = d I - S-+ with the -m
        corner, d = 4r + M + 1 (host-side, trace-time constants)."""
        d = 4.0 * self.r + self.m5 + 1.0
        l5 = self.l5
        s_up = np.zeros((l5, l5))  # (S+ psi)_s = psi_{s+1}, corner -m
        s_dn = np.zeros((l5, l5))
        for s in range(l5 - 1):
            s_up[s, s + 1] = 1.0
            s_dn[s + 1, s] = 1.0
        s_up[l5 - 1, 0] = -self.mass
        s_dn[0, l5 - 1] = -self.mass
        a_plus = d * np.eye(l5) - s_dn  # P+ chirality couples to s-1
        a_minus = d * np.eye(l5) - s_up  # P- chirality couples to s+1
        return a_plus, a_minus

    def _apply_l5(self, m_plus, m_minus, psi):
        """P+ (M+ along s) psi + P- (M- along s) psi (site-local)."""
        pp, pm = self._chiral_masks(psi)
        mp = jnp.asarray(m_plus, dtype=psi.dtype)
        mm = jnp.asarray(m_minus, dtype=psi.dtype)
        return pp * dots.einsum("lk,k...->l...", mp, psi) + pm * dots.einsum(
            "lk,k...->l...", mm, psi
        )

    def apply_a(self, psi, dag: bool = False):
        """The 4D-site-local block A of D (any packing). A^dag swaps
        the chiral matrices: A+^T = A- (real matrices, the -m corners
        transpose onto each other)."""
        a_plus, a_minus = self._a_mats()
        if dag:
            a_plus, a_minus = a_minus, a_plus
        return self._apply_l5(a_plus, a_minus, psi)

    def apply_a_inv(self, psi, dag: bool = False):
        """A^-1 psi via the precomputed chiral L5 x L5 inverses."""
        a_plus, a_minus = self._a_mats()
        if dag:
            a_plus, a_minus = a_minus, a_plus
        return self._apply_l5(np.linalg.inv(a_plus), np.linalg.inv(a_minus), psi)

    def packed_links(self, up):
        """(U_even, U_odd) for phased links (delegates to eo_pack)."""
        from latticeqcd_tpu.ops.dirac import eo_pack

        return eo_pack.pack_links(up, up.shape[1:5])

    @staticmethod
    def pack5(f, lattice, parity: int):
        """5D field (L5,X,Y,Z,T,...) -> packed (L5,X/2,Y,Z,T,...)."""
        from latticeqcd_tpu.ops.dirac import eo_pack

        return jax.vmap(lambda ff: eo_pack.pack(ff, lattice, parity))(f)

    @staticmethod
    def unpack5(fp, lattice, parity: int):
        from latticeqcd_tpu.ops.dirac import eo_pack

        return jax.vmap(lambda ff: eo_pack.unpack(ff, lattice, parity))(fp)

    def _packed_hop(self, u_t, u_s, psi_p, target_parity: int,
                    dag: bool = False):
        """The Wilson-hop block B restricted to target_parity sites:
        psi_p lives on the OPPOSITE parity, packed (L5,X/2,Y,Z,T,4,NC).
        Same stencil inventory as the staggered packed dslash
        (staggered.py _packed_dslash): 3 halo exchanges per sharded
        axis (psi +mu, psi -mu, links -mu). dag=True is the adjoint
        hop B_{ts}^dag = B'_{st}: identical link/gather pattern with
        the projectors swapped (gamma_mu hermitian — see _wilson4)."""
        from latticeqcd_tpu.ops.dirac import eo_pack

        lattice = (2 * u_t.shape[1],) + tuple(u_t.shape[2:5])
        s_t = eo_pack.offset_field(lattice, target_parity)
        pm, pp = gammas.projectors(self.r)
        if dag:
            pm, pp = pp, pm
        pm = jnp.asarray(pm, dtype=psi_p.dtype)
        pp = jnp.asarray(pp, dtype=psi_p.dtype)
        hop = 0.0
        for mu in range(DIRS):
            g_plus = jax.vmap(lambda f, m=mu: eo_pack.gather_plus(f, m, s_t))
            g_minus = jax.vmap(lambda f, m=mu: eo_pack.gather_minus(f, m, s_t))
            fwd = dots.einsum("...ab,l...sb->l...sa", u_t[mu], g_plus(psi_p))
            u_m = eo_pack.gather_minus(u_s[mu], mu, s_t)
            bwd = dots.einsum("...ba,l...sb->l...sa", jnp.conj(u_m), g_minus(psi_p))
            hop = hop + dots.einsum("st,l...tc->l...sc", pm[mu], fwd)
            hop = hop + dots.einsum("st,l...tc->l...sc", pp[mu], bwd)
        return -0.5 * hop

    def apply_schur(self, u_eo, phi_e: jnp.ndarray, dag: bool = False) -> jnp.ndarray:
        """Shat phi = (A - B_eo A^-1 B_oe) phi on packed EVEN fields.

        dag=True gives Shat^dag = A^dag - B_oe^dag A^-dag B_eo^dag,
        which by the projector-swap adjoint rule is the SAME program
        with dag threaded through every block — explicit, so the
        sharded adjoint costs exactly the forward hop's halo permutes
        (a linear_transpose here lowered transposed rolls to
        halo-plane all-reduces, tests/test_collective_audit.py)."""
        u_e, u_o = u_eo
        t = self._packed_hop(u_o, u_e, phi_e, target_parity=1, dag=dag)
        t = self.apply_a_inv(t, dag=dag)
        t = self._packed_hop(u_e, u_o, t, target_parity=0, dag=dag)
        return self.apply_a(phi_e, dag=dag) - t

    def apply_schur_dagger(self, u_eo, phi_e: jnp.ndarray) -> jnp.ndarray:
        return self.apply_schur(u_eo, phi_e, dag=True)

    def apply_schur_ddag_d(self, u_eo, phi_e):
        return self.apply_schur_dagger(u_eo, self.apply_schur(u_eo, phi_e))
