"""The JAX package's MOFNet started from its learned motion hidden state.

The JAX package starts MOF's refinement from zeros (the carry that
`tpuflow/core/mofnet.py` `MOFNet.refine` builds); upstream VideoFlow and
the port start it from the update block's learned `init_hidden_state`.  Port
tests that hold MOF or BOF to the JAX package start the JAX side from the
same learned state inside their own process, and leave the package's files
as they are: `learned_start()` wraps `MOFNet.refine` so that the first carry
it builds holds `init_hidden_state` broadcast over (B, N, h, w), as the
JAX motion encoder itself expands it when handed no state.  `refine_pairs`
and `__call__` reach it through `self.refine`.

JAX's caches are cleared on the way in and on the way out, so that no trace
made under one start is reused under the other (a later test module in the
same worker may hold the JAX package to its own goldens)."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import pytest

from tpuflow.core import mofnet as jmof

ORIG_REFINE = jmof.MOFNet.refine
ORIG_CARRY = jmof._MOFCarry


@contextlib.contextmanager
def learned_start():
    """The JAX MOFNet (and BOFNet) refine from `init_hidden_state` inside
    the block."""
    armed = []          # the learned state of the refine being traced, until its first carry

    def carry(flow, net, motion_hidden_state, mask):
        if armed:
            init = armed.pop()
            motion_hidden_state = jnp.broadcast_to(
                init.astype(motion_hidden_state.dtype), motion_hidden_state.shape)
        return ORIG_CARRY(flow=flow, net=net, motion_hidden_state=motion_hidden_state, mask=mask)

    def refine(self, encoded):
        # Absent while `init` traces the model: the state it would start
        # from is still being drawn, and no test reads an init's output.
        init = self.variables.get("params", {})
        for key in ("iteration", "update_block", "encoder", "init_hidden_state"):
            init = init.get(key) if init is not None else None
        armed[:] = [] if init is None else [init]
        try:
            return ORIG_REFINE(self, encoded)
        finally:
            armed.clear()

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmof, "_MOFCarry", carry)
        mp.setattr(jmof.MOFNet, "refine", refine)
        try:
            yield
        finally:
            jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def jax_learned_start():
    """Every test of a module that imports this fixture runs with the JAX
    MOFNet started from its learned state."""
    with learned_start():
        yield
