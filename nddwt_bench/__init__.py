"""Benchmark of the PyTorch and CUDA port ``non_decimated_wavelets_tpu_torch``
on one H100: ``run.py`` runs one cell of ``BENCHMARK.json`` once."""
