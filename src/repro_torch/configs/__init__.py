"""Model configurations: port of ``repro.configs``."""
from .base import (ModelConfig, MoESpec, SSMSpec, ShapeSpec, SHAPES,
                   get_config, ARCH_IDS)  # noqa: F401
