"""Architecture registry of the port: the dense configs its paged server
runs. A copy of ``repro.configs`` restricted to the dense family, so the
port never imports the JAX package."""
from .base import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs

# importing the modules populates the registry
from . import (llama_paper, qwen15_05b_draft, qwen15_32b,  # noqa: F401
               qwen25_14b)

ALL_ARCHS = True  # sentinel: registry populated

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_archs"]
