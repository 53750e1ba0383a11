"""The benchmark of the PyTorch/CUDA port: ``python3 -m portbench.run``
(see ``run.py``), its cells in ``BENCHMARK.json`` at the repository root."""
