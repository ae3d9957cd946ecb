"""Kernel entries that refuse a gradient instead of dropping it.

A kernel fills a `torch.empty` output through ctypes, so its result would
carry no `grad_fn` and a backward through it would silently stop there.
The JAX package's kernels cannot be differentiated either (its Pallas calls
have no JVP rule, and GMA's flash call has no backward blocks), so its train
step runs the plain formulations.  `refuses_gradient` wraps an entry in an
autograd Function on every device, around the plain version too: the forward
runs as before, with grad enabled or not, and a backward through its result
raises and names the differentiable formulations.
"""

from __future__ import annotations

import functools

import torch

GRADIENT_HINT = (
    "{name} has no backward, as its TPU kernel has none: build the model with "
    "dense_lookup='xla' and gma_impl='xla' (and corr_impl 'dense' or 'auto' on grids "
    "of at most 168x168 cells) to train through the plain formulations"
)


class _Refuse(torch.autograd.Function):
    """Runs `run(*tensors)`; a backward through its outputs raises."""

    @staticmethod
    def forward(ctx, name, run, *tensors):
        ctx.name = name
        out = run(*tensors)
        return tuple(out) if isinstance(out, list) else out

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(GRADIENT_HINT.format(name=ctx.name))


def refuses_gradient(fn):
    """Wrap a kernel entry `fn(*args, **kwargs)`, which returns a tensor or
    a list of tensors, in `_Refuse`.  The tensors among its positional
    arguments, also inside lists and tuples, become the Function's inputs,
    so that a result of inputs that require a gradient gets the refusing
    backward; keyword arguments pass through."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        flat, sizes = [], []
        for a in args:
            seq = isinstance(a, (list, tuple))
            flat.extend(a if seq else [a])
            sizes.append(len(a) if seq else None)

        def run(*tensors):
            rebuilt, i = [], 0
            for size in sizes:
                rebuilt.append(tensors[i] if size is None else list(tensors[i : i + size]))
                i += 1 if size is None else size
            return fn(*rebuilt, **kwargs)

        out = _Refuse.apply(fn.__name__, run, *flat)
        return list(out) if isinstance(out, tuple) else out

    return entry
