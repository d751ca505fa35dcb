"""Architecture registry of the port: every config of ``repro.configs``
(dense GQA, MLA, moe, vlm, ssm, hybrid and audio), copied so the port
never imports the JAX package."""
from .base import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs

# importing the modules populates the registry
from . import (llama_paper, mamba2_780m, minicpm3,  # noqa: F401
               minitron_8b, mixtral, phi35_moe, qwen15_05b_draft,
               qwen15_32b, qwen25_14b, qwen2_vl_2b, recurrentgemma_9b,
               whisper_tiny)

#: The ten assigned architectures (dry-run / roofline cells).
ASSIGNED_ARCHS = (
    "phi3.5-moe-42b-a6.6b",
    "mixtral-8x7b",
    "qwen2.5-14b",
    "minicpm3-4b",
    "minitron-8b",
    "qwen1.5-32b",
    "recurrentgemma-9b",
    "mamba2-780m",
    "qwen2-vl-2b",
    "whisper-tiny",
)

ALL_ARCHS = True  # sentinel: registry populated

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_archs",
           "ASSIGNED_ARCHS"]
