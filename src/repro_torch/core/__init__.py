"""Analytic models and the scheduler of the port (numpy only), copies of
the JAX package's: device and model profiles (``profiles``), the latency
model (``latency``), the Halda solver (``halda``), device-subset selection
(``cluster``) and the piped-ring schedule (``ring``)."""
