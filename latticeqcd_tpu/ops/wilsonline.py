"""Symbolic Wilson-line algebra.

Mirror of Wilsonloop.jl (SURVEY.md 2.4.4): a path is a
tuple of (direction, signed length) segments; loops are evaluated
generically by multiplying rolled link fields, and the *path
derivative* (staple sum) falls out symbolically. This one evaluator
powers general gauge actions, heatbath staples, HMC forces, and all
loop-based observables — the reference's mechanism for "general gauge
action" (README.md:100), rebuilt as trace-once jnp code that XLA
fuses (shifts lower to collective-permutes on a sharded mesh).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import jax.numpy as jnp

from latticeqcd_tpu.ops import sun

from latticeqcd_tpu.ops import rolls

DIRS = 4


@dataclass(frozen=True)
class Wilsonline:
    """A symbolic path: ((mu, signed_length), ...), mu in 0..3.

    Counterpart of Wilsonline{Dim}([(mu,len),...]) in Wilsonloop.jl
    (used at /root/reference/src/measurements/measure_Wilsonloop.jl:121).
    """

    segments: tuple

    def __init__(self, segments: Iterable[Sequence[int]]):
        segs = tuple((int(m), int(s)) for (m, s) in segments if int(s) != 0)
        object.__setattr__(self, "segments", segs)

    def expand(self):
        """Unit steps [(mu, +-1), ...]."""
        out = []
        for mu, length in self.segments:
            step = 1 if length > 0 else -1
            out.extend([(mu, step)] * abs(length))
        return out

    def adjoint(self) -> "Wilsonline":
        """Reversed path (the loops' dagger), cf. `plaqloop'` (universe.jl:91)."""
        return Wilsonline([(mu, -length) for mu, length in reversed(self.segments)])

    def is_closed(self) -> bool:
        disp = [0] * DIRS
        for mu, length in self.segments:
            disp[mu] += length
        return all(d == 0 for d in disp)

    def __repr__(self):
        names = "xyzt"
        return "Wline[" + ",".join(f"{'+' if s > 0 else '-'}{abs(s)}{names[m]}" for m, s in self.segments) + "]"


def make_plaq(mu: int, nu: int) -> Wilsonline:
    """Plaquette loop U_mu U_nu U_mu^-1 U_nu^-1 (Wilsonloop.jl make_plaq)."""
    return Wilsonline([(mu, 1), (nu, 1), (mu, -1), (nu, -1)])


def make_rect(mu: int, nu: int, lmu: int = 2, lnu: int = 1) -> Wilsonline:
    return Wilsonline([(mu, lmu), (nu, lnu), (mu, -lmu), (nu, -lnu)])


def make_cloverloops(mu: int, nu: int):
    """The four plaquettes around a site in the (mu,nu) plane.

    Mirrors the clover field-strength construction
    (/root/reference/src/measurements/unusedfiles/measure_topological_charge.jl:348-359).
    """
    return [
        Wilsonline([(mu, 1), (nu, 1), (mu, -1), (nu, -1)]),
        Wilsonline([(nu, 1), (mu, -1), (nu, -1), (mu, 1)]),
        Wilsonline([(nu, -1), (mu, 1), (nu, 1), (mu, -1)]),
        Wilsonline([(mu, -1), (nu, -1), (mu, 1), (nu, 1)]),
    ]


def make_loops_fromname(name: str, dim: int = 4, lattice=None):
    """Named loop sets (make_loops_fromname, universe.jl:90; kinds at
    /root/reference/src/system/parameter_structs.jl:232-240)."""
    if name == "plaquette":
        return [make_plaq(mu, nu) for mu in range(dim) for nu in range(mu + 1, dim)]
    if name == "rectangular":
        return [make_rect(mu, nu) for mu in range(dim) for nu in range(dim) if mu != nu]
    if name == "chair":
        loops = []
        for mu in range(dim):
            for nu in range(dim):
                for rho in range(dim):
                    if len({mu, nu, rho}) == 3:
                        loops.append(
                            Wilsonline([(mu, 1), (nu, 1), (rho, 1), (mu, -1), (nu, -1), (rho, -1)])
                        )
        return loops
    if name.startswith("polyakov_"):
        axis = {"x": 0, "y": 1, "z": 2, "t": 3}[name.split("_")[1]]
        if lattice is None:
            raise ValueError("polyakov loops need the lattice extent")
        return [Wilsonline([(axis, lattice[axis])])]
    raise ValueError(f"unknown loop set {name!r}")


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _roll_to(field: jnp.ndarray, offset) -> jnp.ndarray:
    """Return g with g[x] = field[x + offset] (site axes are 0..3)."""
    shifts = [-o for o in offset]
    axes = [d for d in range(DIRS)]
    if all(s == 0 for s in shifts):
        return field
    nz_axes = [a for a, s in zip(axes, shifts) if s != 0]
    nz_shifts = [s for s in shifts if s != 0]
    return rolls.roll(field, nz_shifts, axis=nz_axes)


def evaluate_line(u: jnp.ndarray, line: Wilsonline) -> jnp.ndarray:
    """Path-ordered product W(x) starting at every site x.

    u: (4, X, Y, Z, T, NC, NC). Returns (X, Y, Z, T, NC, NC).
    Counterpart of evaluate_gaugelinks! / Loops+evaluate_loops
    (SURVEY.md 2.4.1/2.4.4).
    """
    offset = [0] * DIRS
    result = None
    for mu, sgn in line.expand():
        if sgn > 0:
            link = _roll_to(u[mu], offset)
            offset[mu] += 1
        else:
            offset[mu] -= 1
            link = sun.dagger(_roll_to(u[mu], offset))
        result = link if result is None else sun.mul(result, link)
    if result is None:
        nc = u.shape[-1]
        shape = u.shape[1:]
        result = jnp.broadcast_to(jnp.eye(nc, dtype=u.dtype), shape)
    return result


def evaluate_loop_trace_sum(u: jnp.ndarray, lines) -> jnp.ndarray:
    """sum_x sum_lines tr W(x)  (complex scalar)."""
    total = 0.0 + 0.0j
    for line in lines:
        total = total + jnp.sum(sun.trace(evaluate_line(u, line)))
    return total


# ---------------------------------------------------------------------------
# Path derivative: staples
# ---------------------------------------------------------------------------


def _occurrence_staple(u: jnp.ndarray, steps, k: int, offsets) -> jnp.ndarray:
    """Staple V for the +occurrence at expanded-path position k.

    For loop W(x) = prod_j L_j(x + o_j) with L_k = U_mu(x + o_k),
    sum_x tr W = sum_y tr(U_mu(y) V(y)) with
    V(y) = [prod_{j>k} L_j . prod_{j<k} L_j](x = y - o_k).
    """
    order = list(range(k + 1, len(steps))) + list(range(k))
    base = offsets[k]
    result = None
    for j in order:
        mu_j, sgn_j = steps[j]
        if sgn_j > 0:
            off = [offsets[j][d] - base[d] for d in range(DIRS)]
            link = _roll_to(u[mu_j], off)
        else:
            off = [offsets[j + 1][d] - base[d] for d in range(DIRS)]
            link = sun.dagger(_roll_to(u[mu_j], off))
    # note: for sgn<0 the link lives at the post-step offset
        result = link if result is None else sun.mul(result, link)
    if result is None:
        nc = u.shape[-1]
        result = jnp.broadcast_to(jnp.eye(nc, dtype=u.dtype), u.shape[1:])
    return result


def _path_offsets(steps):
    """Offsets o_j *before* each step j (and the final offset)."""
    offsets = [[0] * DIRS]
    cur = [0] * DIRS
    for mu, sgn in steps:
        cur = list(cur)
        cur[mu] += sgn
        offsets.append(cur)
    return offsets


def staple_sum(u: jnp.ndarray, weighted_lines, mu: int) -> jnp.ndarray:
    """V_mu(y) = sum over all +occurrences of direction mu across
    `weighted_lines` = [(coeff, Wilsonline), ...], such that

        sum_i c_i sum_x tr W_i(x)   (restricted to +mu occurrences)
            = sum_y tr(U_mu(y) V_mu(y)) + (terms without U_mu+).

    For a line set closed under adjoint this yields the full staple
    (the counterpart of calc_dSdUmu!, SURVEY.md 2.4.1): the -mu
    occurrences are the +mu occurrences of the adjoint lines.
    """
    total = None
    for coeff, line in weighted_lines:
        steps = line.expand()
        offsets = _path_offsets(steps)
        for k, (mu_k, sgn_k) in enumerate(steps):
            if mu_k != mu or sgn_k <= 0:
                continue
            # the +occurrence link sits at offset_before = offsets[k]
            v = _occurrence_staple(u, steps, k, offsets)
            contrib = coeff * v
            total = contrib if total is None else total + contrib
    if total is None:
        total = jnp.zeros(u.shape[1:], dtype=u.dtype)
    return total
