"""The weights of a run: one upstream-named state dict drawn from the seed on
the device, in a few large draws, in the dtype the program serves them in,
and handed to both the program and the reference.

The names, shapes and kinds of the parameters come from the plain reference
(built on the meta device).  Random weights at PyTorch's default bounds make
a network whose flow hardly depends on the correlation features or on the
attention (the signal shrinks by sqrt(3) per layer and the biases decide
the flow), so a comparison of flows would not see the lookups or the
aggregation.  So the convolutions and linear layers draw their weights
uniformly within GAIN * sqrt(3 / fan_in) (GAIN = 0.8: at 1.0 the flows run
away over the twelve iterations), GMA's query-key projection within
QK_GAIN times that (peaked attention, as a trained model's), biases within
+-BIAS; LayerNorms are ones and zeros, the learned hidden-state init
N(0, 1), and GMA's gamma U(0, 1) (upstream starts it at 0, which would drop
the aggregation).  The motion encoder's first convolution of the flow
itself (`convf1_`) takes FLOW_GAIN of its bound, so that a flow of 32 px,
the traffic's fastest motion, enters as a feature of about one: at the full
bound the flow fed itself back over the iterations, and a 1080p frame's
mean flow ran from 10 to 460 px by the seed, which video does not do and
which made the flow's error a share of a different thing on every seed."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

GAIN = 0.8
QK_GAIN = 4.0
FLOW_GAIN = 1.0 / 32.0
BIAS = 0.02


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return g


@torch.no_grad()
def draw_state_dict(ref_model: nn.Module, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A state dict with the names and shapes of `ref_model` (any device,
    meta included), drawn on `device` from `seed` and rounded to `dtype`."""
    lows, highs, shapes, names = [], [], [], []
    fixed, normals = {}, []
    for mod_name, mod in ref_model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                fixed[name] = (p.shape, 1.0 if p_name == "weight" else 0.0)
            elif name.endswith("init_hidden_state"):
                normals.append((name, p.shape))
            elif name.endswith("aggregator.gamma"):
                lows.append(0.0), highs.append(1.0), shapes.append(p.shape), names.append(name)
            elif isinstance(mod, (nn.Conv2d, nn.Linear)) and p_name == "weight":
                bound = GAIN * math.sqrt(3.0 / p[0].numel())
                if mod_name.endswith("att.to_qk"):
                    bound *= QK_GAIN
                elif mod_name.endswith("convf1_"):
                    bound *= FLOW_GAIN
                lows.append(-bound), highs.append(bound), shapes.append(p.shape), names.append(name)
            elif p_name == "bias":
                lows.append(-BIAS), highs.append(BIAS), shapes.append(p.shape), names.append(name)
            else:
                raise ValueError(f"no rule draws parameter {name}")
    sizes = [math.prod(s) for s in shapes]
    flat = torch.rand(sum(sizes), generator=generator(seed, device, 1), device=device)
    out = {}
    for name, shape, lo, hi, part in zip(names, shapes, lows, highs, flat.split(sizes)):
        out[name] = (part * (hi - lo) + lo).reshape(shape).to(dtype)
    nsizes = [math.prod(s) for _, s in normals]
    if nsizes:
        flat = torch.randn(sum(nsizes), generator=generator(seed, device, 2), device=device)
        for (name, shape), part in zip(normals, flat.split(nsizes)):
            out[name] = part.reshape(shape).to(dtype)
    for name, (shape, value) in fixed.items():
        out[name] = torch.full(shape, value, device=device, dtype=dtype)
    return {k: out[k] for k in ref_model.state_dict()}
