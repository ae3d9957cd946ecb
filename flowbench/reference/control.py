"""The lower-precision control: the reference put in the program's place and
computed in fp8 (e4m3), the step below the configuration's bfloat16.  Every
convolution and linear layer takes its weights, its input and its output
rounded to fp8 with one scale per tensor (its largest magnitude at 448, the
format's largest), as an fp8 tensor-core product with a float32 accumulator
would see them."""

from __future__ import annotations

import torch
import torch.nn as nn

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@torch.no_grad()
def to_fp8(model: nn.Module) -> nn.Module:
    """`model` itself, switched to the fp8 control (weights rounded in place,
    inputs and outputs rounded by hooks)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.weight.copy_(fp8_round(mod.weight))
            mod.register_forward_pre_hook(lambda m, args: (fp8_round(args[0]),) + tuple(args[1:]))
            mod.register_forward_hook(lambda m, args, out: fp8_round(out))
    return model
