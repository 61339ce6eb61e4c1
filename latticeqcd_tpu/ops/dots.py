"""Contractions written as multiply-and-sum, so that XLA fuses them.

The spin and colour algebra of the lattice operators is made of tiny
contractions repeated at every site: a constant 4x4 or 4x2 spin matrix
on each spinor, a 3x3 link on each colour vector or half spinor,
batched 3x3 link products. Written as ``jnp.einsum``/``jnp.matmul``
they lower to ``dot_general``, which XLA:GPU hands to cuBLAS as separate
GEMM calls with layout copies around them, in TF32 for complex64 by
default. On one H100 that made the complex64 Wilson D-slash at 32^3x64
take 77.6 ms (13 GB/s) and carry a 3e-4 relative error
(chip_smoke.py Phases 1 and 5; PERF.md). Written here as a broadcast
multiply and a sum over the contracted axes, the same contractions are
elementwise work that XLA fuses with the shifts around them, in the
full precision of the dtype, on the GPU and the CPU alike.
"""

from __future__ import annotations

import jax.numpy as jnp


def _labels(sub: str, ndim: int, ell: list) -> list:
    """Subscript letters of one operand, '...' expanded to the trailing
    len(...) of the shared ellipsis labels (numpy's right alignment)."""
    if "..." not in sub:
        return list(sub)
    pre, post = sub.split("...")
    k = len(ell) if ndim is None else ndim - len(pre) - len(post)
    return list(pre) + ell[len(ell) - k:] + list(post)


def _align(x, labels: list, order: list):
    """Transpose x to `order` and insert size-1 axes for its missing labels."""
    present = sorted(labels, key=order.index)
    x = jnp.transpose(x, [labels.index(lbl) for lbl in present])
    return jnp.reshape(x, [x.shape[present.index(lbl)] if lbl in labels else 1
                           for lbl in order])


def einsum(subscripts: str, x, y):
    """Two-operand ``jnp.einsum`` with an explicit output ("ab,...b->...a"),
    computed as broadcast multiply + sum over the contracted labels."""
    ins, out = subscripts.replace(" ", "").split("->")
    sx, sy = ins.split(",")
    n_ell = max(jnp.ndim(x) - len(sx.replace("...", "")) if "..." in sx else 0,
                jnp.ndim(y) - len(sy.replace("...", "")) if "..." in sy else 0)
    ell = [chr(0x3B1 + i) for i in range(n_ell)]  # labels no subscript uses
    lx = _labels(sx, jnp.ndim(x), ell)
    ly = _labels(sy, jnp.ndim(y), ell)
    lo = _labels(out, None, ell)
    summed = [lbl for lbl in dict.fromkeys(lx + ly) if lbl not in lo]
    order = lo + summed
    prod = _align(x, lx, order) * _align(y, ly, order)
    if not summed:
        return prod
    return jnp.sum(prod, axis=tuple(range(len(lo), len(order))))


def matmul(a, b):
    """Batched matrix product on the last two axes (small matrices)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)
