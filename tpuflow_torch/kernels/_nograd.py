"""Kernel entries that refuse a gradient instead of dropping it.

A kernel fills a `torch.empty` output through ctypes, so its result would
carry no `grad_fn` and a backward through it would silently stop there.
The JAX package's kernels cannot be differentiated either (its Pallas calls
have no JVP rule, and GMA's flash call has no backward blocks), so its train
step runs the plain formulations.  `refuses_gradient` wraps an entry in an
autograd Function on every device, around the plain version too, wherever
autograd would record the call: the forward runs as before, and a backward
through its result raises and names the differentiable formulations.
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


def needs_graph(tensors) -> bool:
    """Whether autograd records an operation on `tensors`: grad enabled and
    one of them requiring a gradient.  Otherwise an autograd Function adds
    only its own host cost (tens of microseconds a call), which inference
    skips."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuses_gradient(fn):
    """Wrap a kernel entry `fn(*args, **kwargs)`, which returns a tensor or
    a list of tensors, in `_Refuse`.  The tensors among its positional
    arguments, also inside lists and tuples, become the Function's inputs,
    so that a result of inputs that require a gradient gets the refusing
    backward; keyword arguments pass through.  Where autograd records
    nothing (`needs_graph`), `fn` runs as it is."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if not needs_graph(t for a in args for t in (a if isinstance(a, (list, tuple)) else (a,))):
            return fn(*args, **kwargs)
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
