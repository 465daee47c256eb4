"""Log-depth associative scan over one axis of a tuple of tensors (the
port's counterpart of ``jax.lax.associative_scan``).

``associative_scan(fn, elems, reverse=False, axis=0)`` returns the inclusive
prefix combination of ``elems`` along ``axis``: element k of the result is
fn(...fn(fn(e_0, e_1), e_2)..., e_k).  ``elems`` is a tuple (or NamedTuple)
of tensors that share the length of ``axis``; ``fn(a, b)`` takes and returns
such tuples, with ``a`` the earlier element, and is applied to whole slices
at once, so each level of the recursion is one batched call of ``fn`` over
all its pairs.

The recursion is JAX's odd/even one (``jax/_src/lax/control_flow/loops.py``):
combine adjacent pairs, scan the half-length sequence, then combine each
result with the next original element, and interleave.  So the combination
tree, and with it the floating-point summation order, is the reference's.
``reverse=True`` flips, scans and flips back, so ``fn``'s first argument is
then the element nearer the END of the original sequence.  Autograd
differentiates through it; the saved tensors total about twice the
elements.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _slice(x: torch.Tensor, axis: int, start: int, stop, step: int = 1) -> torch.Tensor:
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a_0, b_0, a_1, b_1, ... along ``axis``; ``a`` may hold one more."""
    nb = b.shape[axis]
    pairs = torch.stack([_slice(a, axis, 0, nb), b], dim=axis + 1).flatten(axis, axis + 1)
    if a.shape[axis] == nb:
        return pairs
    return torch.cat([pairs, _slice(a, axis, nb, None)], dim=axis)


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], reverse: bool = False,
                     axis: int = 0):
    """Inclusive scan of the associative ``fn`` over ``axis`` of ``elems``."""
    kind = type(elems)
    rebuild = (lambda xs: kind(*xs)) if hasattr(elems, "_fields") else kind
    flat = list(elems)
    n = flat[0].shape[axis]
    if any(e.shape[axis] != n for e in flat):
        raise ValueError(f"associative_scan: elements differ in length along axis {axis}: "
                         f"{[tuple(e.shape) for e in flat]}")
    if reverse:
        flat = [torch.flip(e, (axis,)) for e in flat]

    def combine(a, b):
        return list(fn(rebuild(a), rebuild(b)))

    def scan(xs):
        m = xs[0].shape[axis]
        if m < 2:
            return xs
        reduced = combine([_slice(x, axis, 0, m - 1, 2) for x in xs],
                          [_slice(x, axis, 1, None, 2) for x in xs])
        odd = scan(reduced)
        if m % 2 == 0:
            even = combine([_slice(o, axis, 0, -1) for o in odd],
                           [_slice(x, axis, 2, None, 2) for x in xs])
        else:
            even = combine(odd, [_slice(x, axis, 2, None, 2) for x in xs])
        even = [torch.cat([_slice(x, axis, 0, 1), e], dim=axis) for x, e in zip(xs, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    out = scan(flat)
    if reverse:
        out = [torch.flip(e, (axis,)) for e in out]
    return rebuild(out)
