"""Grouped low-bit weight quantization of the port (q4, q2)."""
from .grouped import (DEFAULT_GROUP, QuantizedTensor, dequantize_leaf,
                      dequantize_q2, dequantize_q4, dequantize_tree, map_tree,
                      pack_q2, pack_q4, quantize_q2, quantize_q4,
                      quantize_tree, tree_tensors, unpack_q2, unpack_q4)

__all__ = ["DEFAULT_GROUP", "QuantizedTensor", "dequantize_leaf",
           "dequantize_q2", "dequantize_q4", "dequantize_tree", "map_tree",
           "pack_q2", "pack_q4", "quantize_q2", "quantize_q4",
           "quantize_tree", "tree_tensors", "unpack_q2", "unpack_q4"]
