from .model import (DenseModel, decode_step, decode_step_layerwise,
                    decode_step_paged, forward, forward_layerwise,
                    init_cache, init_params, prefill, prefill_chunk_paged,
                    prefill_layerwise, rollback_cache)

__all__ = ["DenseModel", "decode_step", "decode_step_layerwise",
           "decode_step_paged", "forward", "forward_layerwise",
           "init_cache", "init_params", "prefill", "prefill_chunk_paged",
           "prefill_layerwise", "rollback_cache"]
