"""The benchmark of the port ``dspmap_tpu_torch`` (``run.py`` runs one
cell; ``BENCHMARK.json`` at the checkout's root names the cells)."""
