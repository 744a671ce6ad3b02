"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a
harness driven by data (``BENCHMARK.json`` at the repo root, and the
configuration, traffic, generator, runner, reference and metric files it
names under this directory). ``run.py`` runs one cell once; it imports
nothing of JAX or of the JAX package."""
