from .model import (DenseModel, decode_step, decode_step_paged, init_cache,
                    init_params, prefill, prefill_chunk_paged,
                    rollback_cache)

__all__ = ["DenseModel", "decode_step", "decode_step_paged", "init_cache",
           "init_params", "prefill", "prefill_chunk_paged",
           "rollback_cache"]
