"""Staggered (Kogut-Susskind) Dirac operator.

Counterpart of LatticeDiracOperators.jl's staggered operator
(SURVEY.md 2.4.2; params mass/Nf at
/root/reference/src/system/universe.jl:106-110):

    D psi(x) = m psi(x)
      + (1/2) sum_mu eta_mu(x) [ U_mu(x) psi(x+mu)
                               - U_mu(x-mu)^dag psi(x-mu) ]

with Kogut-Susskind phases eta_1 = 1, eta_mu = (-1)^(x_1+..+x_{mu-1})
and boundary phases absorbed into the links. Field layout:
psi[X, Y, Z, T, NC]. D = m + Dslash with Dslash antihermitian and
even-odd off-diagonal, so D^dag D = m^2 - Dslash^2 is block-diagonal
in parity — the even block W = (D^dag D)_ee with det W = det D (4
tastes) is the solver/HMC workhorse (see ops/fermion_action.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from latticeqcd_tpu.ops.dirac import eo_pack

from latticeqcd_tpu.ops import dots, rolls

DIRS = 4


def ks_phases(lattice):
    """eta_mu(x) as four {-1,+1} site fields, and the parity mask."""
    grids = np.meshgrid(*(np.arange(l) for l in lattice), indexing="ij")
    etas = []
    acc = np.zeros(lattice, dtype=np.int64)
    for mu in range(DIRS):
        etas.append(1.0 - 2.0 * (acc % 2))
        acc = acc + grids[mu]
    parity_even = (sum(grids) % 2) == 0
    return np.stack(etas), parity_even


def _shift(f, mu, steps):
    return rolls.roll(f, -steps, axis=mu)


@dataclass(frozen=True)
class StaggeredDirac:
    mass: float
    lattice: tuple
    bc: tuple = (1, 1, 1, -1)

    @property
    def eta(self):
        return jnp.asarray(ks_phases(self.lattice)[0])

    @property
    def even_mask(self):
        return jnp.asarray(ks_phases(self.lattice)[1])

    def dslash(self, u: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
        """Antihermitian hopping part (1/2) sum eta_mu (T+ - T-)."""
        eta = self.eta.astype(psi.dtype)
        out = 0.0
        for mu in range(DIRS):
            umu = u[mu]
            fwd = dots.einsum("...ab,...b->...a", umu, _shift(psi, mu, +1))
            bwd = dots.einsum(
                "...ba,...b->...a", jnp.conj(_shift(umu, mu, -1)), _shift(psi, mu, -1)
            )
            out = out + 0.5 * eta[mu][..., None] * (fwd - bwd)
        return out

    def apply(self, u: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
        """D psi = m psi + Dslash psi."""
        return self.mass * psi + self.dslash(u, psi)

    def apply_dagger(self, u: jnp.ndarray, psi: jnp.ndarray) -> jnp.ndarray:
        return self.mass * psi - self.dslash(u, psi)

    def apply_w_even(self, u: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
        """W phi = (m^2 - Dslash^2) phi for even-supported phi.

        The even-odd preconditioned normal operator: spectrum in
        [m^2, m^2 + 16]; det W (over even sites) = det D.
        """
        even = self.even_mask[..., None]
        phi_e = jnp.where(even, phi, 0.0)
        d1 = self.dslash(u, phi_e)  # odd-supported
        d2 = self.dslash(u, d1)  # even-supported
        return jnp.where(even, self.mass**2 * phi_e - d2, 0.0)

    def apply_ddag_d(self, u, psi):
        """(m^2 - Dslash^2) psi on the full lattice."""
        return self.mass**2 * psi - self.dslash(u, self.dslash(u, psi))

    # ------------------------------------------------------------------
    # Packed even-odd layout (shared machinery in eo_pack.py)
    #
    # The solver/HMC hot loop works on even-supported fields only; the
    # masked apply_w_even above still streams full-volume arrays, i.e.
    # 2x the memory traffic and arithmetic actually needed. Everything in
    # the CG iteration runs on V/2-site packed arrays instead.
    # ------------------------------------------------------------------

    def pack(self, f: jnp.ndarray, parity: int) -> jnp.ndarray:
        return eo_pack.pack(f, self.lattice, parity)

    def unpack(self, fp: jnp.ndarray, parity: int) -> jnp.ndarray:
        return eo_pack.unpack(fp, self.lattice, parity)

    def packed_links(self, u: jnp.ndarray):
        return eo_pack.pack_links(u, self.lattice)

    def _packed_eta(self, parity: int):
        return self.pack(jnp.moveaxis(self.eta, 0, -1), parity)  # (...,4)

    def _packed_dslash(self, u_t, u_s, psi_s, target_parity: int):
        """(Dslash psi)(x) on target-parity sites; psi lives on the
        source parity. u_t/u_s are the packed link arrays of the
        target/source parity."""
        s_t = eo_pack.offset_field(self.lattice, target_parity)
        eta_t = self._packed_eta(target_parity)  # (X/2,Y,Z,T,4)
        out = 0.0
        for mu in range(DIRS):
            fwd = dots.einsum("...ab,...b->...a", u_t[mu],
                             eo_pack.gather_plus(psi_s, mu, s_t))
            u_m = eo_pack.gather_minus(u_s[mu], mu, s_t)
            bwd = dots.einsum("...ba,...b->...a", jnp.conj(u_m),
                             eo_pack.gather_minus(psi_s, mu, s_t))
            out = out + 0.5 * eta_t[..., mu, None].astype(psi_s.dtype) * (fwd - bwd)
        return out

    def apply_w_packed(self, u_eo, phi_pe: jnp.ndarray) -> jnp.ndarray:
        """W phi = (m^2 - D_eo D_oe) phi on PACKED even fields
        (X/2,Y,Z,T,NC) — identical to apply_w_even up to the layout
        (pinned in tests/test_dirac.py)."""
        u_e, u_o = u_eo
        d1 = self._packed_dslash(u_o, u_e, phi_pe, target_parity=1)
        d2 = self._packed_dslash(u_e, u_o, d1, target_parity=0)
        return self.mass**2 * phi_pe - d2
