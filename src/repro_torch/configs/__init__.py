"""Architecture registry of the port: the configs of the families it
serves, dense GQA, moe and ssm (Mamba-2). A copy of the matching modules
of ``repro.configs``, so the port never imports the JAX package."""
from .base import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs

# importing the modules populates the registry
from . import (llama_paper, mamba2_780m, minitron_8b,  # noqa: F401
               mixtral, phi35_moe, qwen15_05b_draft, qwen15_32b,
               qwen25_14b)

ALL_ARCHS = True  # sentinel: registry populated

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_archs"]
