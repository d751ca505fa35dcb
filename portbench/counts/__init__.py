"""Frozen operation and byte counts of the port's kernels and of a model
step, one file a kernel, with the chip's peaks (``peaks.py``). The bytes
count each input read once and each output written once; the operations
count multiply-adds twice. A bound is the larger of bytes over the peak
bandwidth and operations over the peak rate."""
