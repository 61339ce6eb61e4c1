"""Molecular-dynamics integrators (pure functions, jit-compiled).

Mirror of the reference MD layer (SURVEY.md 2.2 rows
"MD abstract layer"/"MD integrators"; /root/reference/src/md/
standardMD.jl:126-190, AbstractMD.jl:78-135):

* QPQ leapfrog:            [U(1/2) P(1) U(1/2)] x MDsteps
* PQP leapfrog:            [P(1/2) U(1) P(1/2)] x MDsteps
* Sexton-Weingarten QPQ:   Nsw/2 gauge sub-iterations of
                           [U(.5/Nsw) P_g(1/Nsw) U(.5/Nsw)],
                           one fermion kick (1), then the second half
                           — multi-timescale nesting exactly as
                           standardMD.jl:144-167.

State is (U, H): links U[4,X,Y,Z,T,NC,NC] and traceless-hermitian
momenta H of the same shape. Evolution U <- exp(i eps H) U,
H <- H + eps * force(U), with force = Hdot (the conservative sign is
baked into the force functions; see ops/gauge_action.force). Each
trajectory is ONE jitted XLA program: the step loop is a
lax.fori_loop, so MDsteps does not unroll the graph.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from latticeqcd_tpu.ops import mdpair, sun

DIRS = 4


def update_links(u, h, eps):
    """U <- exp(i eps H) U for all four directions (U_update!,
    AbstractMD.jl:78-98).

    Polymorphic over the MD state representation: plain complex arrays
    (production), or f64 mdpair.PairField state for the mixed-precision
    integrator (md_precision='mixed' — the kick accumulation
    `h + eps*f` is handled by PairField.__add__, so the integrator
    bodies below run unchanged on either representation; the force
    closures receive a lowered complex view, built by the HMC layer)."""
    if isinstance(u, mdpair.PairField):
        return mdpair.update_links(u, h, eps)
    e = sun.expi_hermitian(h, eps)
    return sun.mul(e, u)


def _loop(body, n: int, carry, unroll: bool):
    """fori_loop, or a Python unroll. The integrators below unroll by
    default whenever the body contains a while_loop (a Krylov solve),
    which also lets the fermion-force closures thread each step's CG
    solution into the next step as a warm start; program size and
    compile time then grow with MDsteps. The body receives the true
    step index in both modes (Omelyan's final kick differs)."""
    if unroll:
        for i in range(n):
            carry = body(i, carry)
        return carry
    return jax.lax.fori_loop(0, n, body, carry)


def leapfrog_qpq(
    u: jnp.ndarray,
    h: jnp.ndarray,
    force_gauge: Callable,
    dtau: float,
    md_steps: int,
    force_fermion: Optional[Callable] = None,
    unroll: Optional[bool] = None,
):
    """runMD_QPQ! (standardMD.jl:126-142)."""
    if unroll is None:
        unroll = force_fermion is not None

    def body(_, carry):
        u, h = carry
        u = update_links(u, h, 0.5 * dtau)
        h = h + dtau * force_gauge(u)
        if force_fermion is not None:
            h = h + dtau * force_fermion(u)
        u = update_links(u, h, 0.5 * dtau)
        return (u, h)

    return _loop(body, md_steps, (u, h), unroll)


def leapfrog_pqp(
    u: jnp.ndarray,
    h: jnp.ndarray,
    force_gauge: Callable,
    dtau: float,
    md_steps: int,
    force_fermion: Optional[Callable] = None,
    unroll: Optional[bool] = None,
):
    """runMD_PQP! (standardMD.jl:170-190)."""
    if unroll is None:
        unroll = force_fermion is not None

    def body(_, carry):
        u, h = carry
        h = h + 0.5 * dtau * force_gauge(u)
        if force_fermion is not None:
            h = h + 0.5 * dtau * force_fermion(u)
        u = update_links(u, h, dtau)
        h = h + 0.5 * dtau * force_gauge(u)
        if force_fermion is not None:
            h = h + 0.5 * dtau * force_fermion(u)
        return (u, h)

    return _loop(body, md_steps, (u, h), unroll)


# Omelyan/Mukherjee/Petreczky 2nd-order minimum-norm coefficient
# (Omelyan-Mryglod-Folk, hep-lat/0505020 eq. 31: lambda minimizing the
# norm of the leading O(eps^2) error operator). Two force evaluations
# per step buy a ~10x smaller error constant than leapfrog, so at
# matched acceptance the step size roughly doubles — a net win on any
# force-dominated (dynamical) trajectory. Not in the reference (its MD
# menu is QPQ/PQP/SW leapfrog only, standardMD.jl:126-190).
OMELYAN_2MN_LAMBDA = 0.1931833275037836


def omelyan_pqp(
    u: jnp.ndarray,
    h: jnp.ndarray,
    force_gauge: Callable,
    dtau: float,
    md_steps: int,
    force_fermion: Optional[Callable] = None,
    lam: float = OMELYAN_2MN_LAMBDA,
    unroll: Optional[bool] = None,
):
    """2nd-order minimum-norm (2MN) PQP-form integrator:

        P(lam e) U(e/2) P((1-2 lam) e) U(e/2) P(lam e)

    per step, with the adjacent lam-kicks of consecutive steps merged
    into one 2*lam kick (2 force evaluations per step + 1 initial)."""
    if unroll is None:
        unroll = force_fermion is not None

    def kick(u, h, eps):
        h = h + eps * force_gauge(u)
        if force_fermion is not None:
            h = h + eps * force_fermion(u)
        return h

    h = kick(u, h, lam * dtau)

    def body(i, carry):
        u, h = carry
        u = update_links(u, h, 0.5 * dtau)
        h = kick(u, h, (1.0 - 2.0 * lam) * dtau)
        u = update_links(u, h, 0.5 * dtau)
        # merged trailing+leading lam kicks, except after the last step
        last = i == md_steps - 1
        if unroll:
            c = lam if last else 2.0 * lam
        else:
            c = jnp.where(last, lam, 2.0 * lam)
        h = kick(u, h, c * dtau)
        return (u, h)

    return _loop(body, md_steps, (u, h), unroll)


def leapfrog_qpq_sw(
    u: jnp.ndarray,
    h: jnp.ndarray,
    force_gauge: Callable,
    dtau: float,
    md_steps: int,
    force_fermion: Callable,
    nsw: int = 2,
    unroll: Optional[bool] = None,
    force_fine: Optional[Callable] = None,
):
    """Sexton-Weingarten multi-timescale QPQ (standardMD.jl:144-167).

    nsw must be even (asserted by the reference, standardMD.jl:56).
    force_fine: optional extra force integrated on the FINE (gauge)
    timescale — e.g. the heavy term of a Hasenbusch split; it may
    contain a solver, so the fine loop unrolls when it is given.
    """
    if nsw % 2 != 0:
        raise ValueError(f"Nsw must be even, got {nsw}")
    if unroll is None:
        unroll = True  # the fermion kick always contains a solver

    def gauge_half(carry):
        def inner(_, c):
            u, h = c
            u = update_links(u, h, 0.5 * dtau / nsw)
            f = force_gauge(u)
            if force_fine is not None:
                f = f + force_fine(u)
            h = h + (dtau / nsw) * f
            u = update_links(u, h, 0.5 * dtau / nsw)
            return (u, h)

        if force_fine is not None:
            for _ in range(nsw // 2):
                carry = inner(0, carry)
            return carry
        return jax.lax.fori_loop(0, nsw // 2, inner, carry)

    def body(_, carry):
        carry = gauge_half(carry)
        u, h = carry
        h = h + dtau * force_fermion(u)
        carry = gauge_half((u, h))
        return carry

    return _loop(body, md_steps, (u, h), unroll)


def omelyan_sw(
    u: jnp.ndarray,
    h: jnp.ndarray,
    force_gauge: Callable,
    dtau: float,
    md_steps: int,
    force_fermion: Callable,
    nsw: int = 2,
    lam: float = OMELYAN_2MN_LAMBDA,
    unroll: Optional[bool] = None,
    force_fine: Optional[Callable] = None,
):
    """Multi-timescale Omelyan 2MN: the 2MN scheme on the fermion
    (outer) timescale with the link drift replaced by nested gauge
    leapfrog sub-integration (the Sexton-Weingarten split, but with
    minimum-norm outer kicks instead of the reference's plain QPQ
    nesting, standardMD.jl:144-167):

        P_f(lam e) G(e/2) P_f((1-2 lam) e) G(e/2) P_f(lam e)

    where G(t) = nsw/2 iterations of [U(t/nsw) P_g(2t/nsw) U(t/nsw)]
    gauge-leapfrog. The expensive fermion force (a CG solve) is
    evaluated twice per step while the cheap gauge force runs on the
    fine scale — the standard production setup for dynamical HMC.
    force_fine: optional extra fine-scale force (Hasenbusch heavy
    term). nsw must be even (mirrors the reference's assertion)."""
    if nsw % 2 != 0:
        raise ValueError(f"Nsw must be even, got {nsw}")
    if unroll is None:
        unroll = True  # the fermion kick always contains a solver

    def gauge_evolve(carry, t):
        """Gauge-only QPQ leapfrog for time t in nsw/2 sub-iterations."""
        eps = t / (nsw // 2)

        def inner(_, c):
            u, h = c
            u = update_links(u, h, 0.5 * eps)
            f = force_gauge(u)
            if force_fine is not None:
                f = f + force_fine(u)
            h = h + eps * f
            u = update_links(u, h, 0.5 * eps)
            return (u, h)

        if force_fine is not None:
            for _ in range(nsw // 2):
                carry = inner(0, carry)
            return carry
        return jax.lax.fori_loop(0, nsw // 2, inner, carry)

    h = h + lam * dtau * force_fermion(u)

    def body(i, carry):
        u, h = carry
        u, h = gauge_evolve((u, h), 0.5 * dtau)
        h = h + (1.0 - 2.0 * lam) * dtau * force_fermion(u)
        u, h = gauge_evolve((u, h), 0.5 * dtau)
        last = i == md_steps - 1
        if unroll:
            c = lam if last else 2.0 * lam
        else:
            c = jnp.where(last, lam, 2.0 * lam)
        h = h + c * dtau * force_fermion(u)
        return (u, h)

    return _loop(body, md_steps, (u, h), unroll)


def run_md(
    u,
    h,
    force_gauge,
    dtau,
    md_steps,
    force_fermion=None,
    scheme: str = "QPQ",
    sexton_weingarten: bool = False,
    nsw: int = 2,
    unroll=None,
    omelyan_lambda: float = OMELYAN_2MN_LAMBDA,
    force_fine=None,
):
    """Dispatch mirroring runMD! (standardMD.jl:103-124). force_fine
    is only meaningful with sexton_weingarten (fine-scale extra force,
    e.g. the Hasenbusch heavy term)."""
    if scheme == "QPQ":
        if sexton_weingarten:
            if force_fermion is None:
                raise ValueError(
                    "The quench update does not need the SextonWeingarten method"
                )
            return leapfrog_qpq_sw(
                u, h, force_gauge, dtau, md_steps, force_fermion, nsw,
                unroll=unroll, force_fine=force_fine,
            )
        return leapfrog_qpq(u, h, force_gauge, dtau, md_steps, force_fermion, unroll=unroll)
    if scheme == "PQP":
        if sexton_weingarten:
            raise ValueError("PQP update with SextonWeingarten is not supported")
        return leapfrog_pqp(u, h, force_gauge, dtau, md_steps, force_fermion, unroll=unroll)
    if scheme == "Omelyan":
        if sexton_weingarten:
            if force_fermion is None:
                raise ValueError(
                    "The quench update does not need the SextonWeingarten method"
                )
            return omelyan_sw(
                u, h, force_gauge, dtau, md_steps, force_fermion,
                nsw=nsw, lam=omelyan_lambda, unroll=unroll,
                force_fine=force_fine,
            )
        return omelyan_pqp(
            u, h, force_gauge, dtau, md_steps, force_fermion,
            lam=omelyan_lambda, unroll=unroll,
        )
    raise ValueError(f"unknown MD scheme {scheme!r}")
