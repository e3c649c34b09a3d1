"""Full-model save/load (serving checkpoints), the port's counterpart of the
JAX package's `serialization`.

`save_pretrained` writes `config.json`, the same dict as the JAX package
writes (its `scan_layers` field included, False), and the port's whole
state_dict as `model.pt`. `load_pretrained` reads a `config.json` written
by either package: JAX-only fields such as `scan_layers` are accepted and
change nothing, the port having one layer layout. The JAX package's Orbax
parameter directory is not read: that needs JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from .configs import DecoderConfig, FlamingoConfig, VisionConfig
from .device import resolve_device
from .models.flamingo import Flamingo

WEIGHTS = "model.pt"
# FlamingoConfig fields of the JAX package that the port does not keep
_JAX_ONLY = {"scan_layers": False}


def config_to_dict(cfg: FlamingoConfig) -> dict:
    top = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in ("vision", "lm")}
    return {"vision": dataclasses.asdict(cfg.vision), "lm": dataclasses.asdict(cfg.lm), **top, **_JAX_ONLY}


def config_from_dict(d: dict) -> FlamingoConfig:
    d = {k: v for k, v in d.items() if k not in _JAX_ONLY}
    return FlamingoConfig(vision=VisionConfig(**d.pop("vision")), lm=DecoderConfig(**d.pop("lm")), **d)


def save_pretrained(path: str, model: Flamingo) -> str:
    """Write {path}/config.json and {path}/model.pt."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_dict(model.cfg), f, indent=2)
    torch.save(model.state_dict(), os.path.join(path, WEIGHTS))
    return path


def load_pretrained(path: str, device="cuda", dtype=torch.float32) -> Flamingo:
    """The model saved at `path`, on `device` in `dtype`."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    model = Flamingo(cfg, device=dev, dtype=dtype)
    model.load_state_dict(torch.load(os.path.join(path, WEIGHTS), map_location=dev, weights_only=True))
    return model
