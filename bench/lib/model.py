"""The program's model configuration, built from a configuration file:
the keys that are ``ModelConfig`` fields, lists as tuples."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


def model_config(config: Dict[str, Any]):
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config.items() if k in names})
