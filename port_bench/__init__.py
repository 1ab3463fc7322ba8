"""The benchmark of the PyTorch and CUDA port (``stellar_tpu_torch``).

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``); ``BENCHMARK.json`` at the
root of the checkout lists the cells, the configurations and the metrics.
Each configuration (``configs/``), traffic mix (``traffic/``), entry
(``entries/``) and metric (``metrics/``) is a file of its own, found by
name (``cells.py``).  The yardstick lives here too: the traffic generator
(``generator.py``), the frozen reference verifier (``reference/``), the
card's peaks and the kernels' work a lane (``roofline.py``), the device
trace's reading (``devtrace.py``) and the control of the comparison that
decides ``correct`` (``control.py``).  Tests: ``python -m pytest
port_bench/tests -q`` (the ``cuda`` ones run on a card only).

Nothing here imports ``jax`` or the JAX package ``stellar_tpu``.
"""
