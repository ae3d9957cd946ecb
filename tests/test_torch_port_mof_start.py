"""MOF's refinement starts from the learned motion hidden state.

The port's MOFNet starts its motion hidden state from the update block's
`init_hidden_state`, as upstream VideoFlow does (the JAX package starts it
from zeros).  Held here on the CPU in float32 against the independent
mirror (tests/mirrors/mof_torch.py) on one set of seeded weights, the
engine's `init_random_`, which draws the learned state N(0, 1): at that
unit scale it moves the flow.  MOF runs at T = 5, BOF at T = 3 (one
interior frame), and the tiled stride-1 entry on two tiles against the
mirror tile by tile.  With the state started from zeros instead, the same
comparisons fail by far.

Frames are 64 x 96 (two of those side by side for the tiles): the strides
of the Twins encoders divide every grid, so the port's SAME-padded strided
convs (core/encoders.py) read what upstream's unpadded ones read.
"""

import contextlib

import numpy as np
import pytest
import torch

from tests.mirrors.mof_torch import MOFNetMirror
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from tpuflow_torch.config import ModelConfig
from tpuflow_torch.core.mofnet import BOFNet, MOFNet
from tpuflow_torch.runtime.engine import FlowEngine, init_random_

CFG = dict(corr_levels=2, corr_radius=2, decoder_depth=2)
H, W = 64, 96
# End-point gaps as shares of the mirror's mean flow.  float32 on both sides
# and the same operations in another order (the lookups' bilinear sums
# against grid_sample, GMA's softmax in blocks, NHWC against NCHW convs):
# sound runs read 5e-7 (mean) and 1.5e-6 (largest).  The zero start reads
# 1.2e-3 to 6.5e-3 (mean).
MEAN_TOL, MAX_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def mirror():
    model = MOFNetMirror(**CFG).eval()
    init_random_(model, 7)
    return model


def port_model(cls, mirror):
    model = cls(corr_dtype=torch.float32, **CFG).eval()
    model.load_state_dict(mirror.state_dict(), strict=True)
    return model


@contextlib.contextmanager
def zero_start(model):
    """The refinement of `model` started from zeros, as the JAX package
    starts it, inside the block."""
    enc = model.update_block.encoder
    orig = enc.forward

    def forward(flow, mhs, corr, bs):
        if mhs is None:
            bn, _, h, w = flow.shape
            mhs = torch.zeros((bs, bn // bs, enc.hidden_ch, h, w), dtype=corr.dtype)
        return orig(flow, mhs, corr, bs)

    enc.forward = forward
    try:
        yield
    finally:
        del enc.forward


def gaps(got: np.ndarray, ref: np.ndarray):
    """(mean, largest) end-point gap of flows [..., 2] over the mean |ref|."""
    epe = np.sqrt(((got - ref) ** 2).sum(-1))
    scale = np.sqrt((ref**2).sum(-1)).mean()
    return epe.mean() / scale, epe.max() / scale


def mirror_flows(mirror, frames: np.ndarray):
    """frames [B, T, H, W, 3] -> the mirror's (forward, backward) flows,
    each [B, T-2, H, W, 2]."""
    with torch.no_grad():
        fwd, bwd = mirror(torch.from_numpy(frames).permute(0, 1, 4, 2, 3))
    return fwd.permute(0, 1, 3, 4, 2).numpy(), bwd.permute(0, 1, 3, 4, 2).numpy()


@pytest.mark.parametrize("cls,t", [(MOFNet, 5), (BOFNet, 3)], ids=["mof-T5", "bof-T3"])
@pytest.mark.parametrize("start", ["learned", "zeros"])
def test_forward_starts_from_the_learned_state(mirror, cls, t, start):
    """Both directions' flows of every interior frame against the mirror:
    within the tolerances from the learned state, outside them from zeros."""
    frames = np.random.default_rng(5).random((1, t, H, W, 3), np.float32)
    ref = mirror_flows(mirror, frames)
    model = port_model(cls, mirror)
    with torch.no_grad(), (zero_start(model) if start == "zeros" else contextlib.nullcontext()):
        got = [f.numpy() for f in model(torch.from_numpy(frames))]
    for name, g, r in zip(("fwd", "bwd"), got, ref):
        mean, largest = gaps(g, r)
        if start == "learned":
            assert mean <= MEAN_TOL and largest <= MAX_TOL, (name, mean, largest)
        else:
            assert mean > 10 * MEAN_TOL, (name, mean, largest)


def centred_window(n: int, i: int, length: int):
    start, end = max(0, i - length // 2), min(n, i + length // 2 + 1)
    seq = list(range(start, end))
    while len(seq) < length:
        seq = [seq[0]] + seq if start == 0 else seq + [seq[-1]]
    return seq


@pytest.mark.parametrize("start", ["learned", "zeros"])
def test_tiled_stride1_starts_from_the_learned_state(mirror, start):
    """compute_flows_tiled_stride1 on six frames of two 64 x 96 tiles (its
    per-tile feature cache, window assembly and paste; volumes in float32)
    against the mirror on each frame's centred window, tile by tile."""
    n, t = 6, 5
    frames = np.random.default_rng(6).random((n, H, 2 * W, 3), np.float32)
    cfg = ModelConfig(model="videoflow", architecture="mof", encoder="twins", sequence_length=t, **CFG)
    eng = FlowEngine(cfg, params=mirror.state_dict(), device="cpu")
    eng.load_model()
    eng.model.corr_dtype = torch.float32
    with zero_start(eng.model) if start == "zeros" else contextlib.nullcontext():
        got = eng.compute_flows_tiled_stride1(frames, tile_size=W)
    ref = np.zeros_like(got)
    for i in range(n):
        win = frames[centred_window(n, i, t)]
        tiles = np.stack([win[:, :, x : x + W] for x in (0, W)])
        fwd, _ = mirror_flows(mirror, tiles)
        ref[i] = np.concatenate(list(fwd[:, (t - 2) // 2]), axis=1)
    mean, largest = gaps(got, ref)
    if start == "learned":
        assert mean <= MEAN_TOL and largest <= MAX_TOL, (mean, largest)
    else:
        assert mean > 10 * MEAN_TOL, (mean, largest)
