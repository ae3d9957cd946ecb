"""Builders of both sides from a configuration file: the plain reference
(`reference_model`) and the program's engine (`program_engine`)."""

from __future__ import annotations

import importlib

import torch


def reference_model(config: dict, device, dtype=torch.float32):
    """The configuration's plain reference model on `device`, parameters
    uninitialized (meta: shapes only).  `reference` names it as
    `<module of flowbench/reference>:<class>`."""
    module, cls = config["reference"].split(":")
    cls = getattr(importlib.import_module(f"flowbench.reference.{module}"), cls)
    with torch.device(device):
        model = cls(**config["reference_args"])
    return model.to(dtype).eval()


def program_engine(config: dict, state_dict, device):
    """The program's FlowEngine for the configuration, loaded with
    `state_dict` through its normal path (strict)."""
    from tpuflow_torch.config import ModelConfig
    from tpuflow_torch.runtime.engine import FlowEngine

    engine = FlowEngine(ModelConfig(**config["model_config"]), params=state_dict, device=device)
    engine.load_model()
    return engine
