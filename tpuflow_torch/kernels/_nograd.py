"""Kernel entries that refuse a gradient instead of dropping it, and the
stages that recompute one through their plain twin.

A kernel fills a `torch.empty` output through ctypes, so its result would
carry no `grad_fn` and a backward through it would silently stop there.
The JAX package's kernels cannot be differentiated either (its Pallas calls
have no JVP rule, and GMA's flash call has no backward blocks), so its train
step runs the plain formulations.  `refuses_gradient` wraps an entry in an
autograd Function on every device, around the plain version too, wherever
autograd would record the call: the forward runs as before, and a backward
through its result raises and names the differentiable formulations.

A kernel with no TPU counterpart (K7, K8) runs in the train step too:
`recomputes_gradient` runs it forward and differentiates its plain twin,
recomputed on the saved inputs, in the backward.
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


class _Recompute(torch.autograd.Function):
    """Runs `run(*tensors)`; the backward recomputes `plain(*tensors)` on the
    saved inputs and differentiates that."""

    @staticmethod
    def forward(ctx, run, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return run(*tensors)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            y = ctx.plain(*inputs)
        grads = iter(torch.autograd.grad(y, wanted, grad))
        return (None, None, *(next(grads) if t is not None and t.requires_grad else None for t in inputs))


def recomputes_gradient(kernel, plain, *tensors):
    """`kernel(*tensors)`, a kernel entry, on CUDA tensors, and `plain(*tensors)`,
    its plain twin, on CPU tensors as they lie.  The tensors lie on the first
    one's device; None stands for an absent input.  Where autograd records
    the call (`needs_graph`), the backward recomputes `plain` on the saved
    inputs and differentiates that, on either device."""
    run = plain if tensors[0].device.type == "cpu" else kernel
    if not needs_graph(tensors):
        return run(*tensors)
    return _Recompute.apply(run, plain, *tensors)
