"""The runtime clock (``repro.runtime.telemetry.clock``): monotonic and
high resolution; the engine stamps request timings with it."""
import time

clock = time.perf_counter
