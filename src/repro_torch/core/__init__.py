"""Analytic models of the port (numpy only): so far the latency terms the
tiered KV memory prices with (``latency``)."""
