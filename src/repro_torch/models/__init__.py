from .model import (DenseModel, WhisperModel, decode_step,
                    decode_step_layerwise, decode_step_paged,
                    default_positions, forward, forward_layerwise,
                    init_cache, init_params, prefill, prefill_chunk_paged,
                    prefill_layerwise, rollback_cache)

__all__ = ["DenseModel", "WhisperModel", "decode_step",
           "decode_step_layerwise", "decode_step_paged", "default_positions",
           "forward", "forward_layerwise", "init_cache", "init_params",
           "prefill", "prefill_chunk_paged", "prefill_layerwise",
           "rollback_cache"]
