"""Serving runtime of the port: paged KV cache and continuous batcher."""
