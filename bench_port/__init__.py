"""The benchmark of the PyTorch and CUDA port (``video_gpt_tpu_torch``) on
one H100. ``run.py`` runs one cell once; ``BENCHMARK.json`` at the root of
the repository lists the cells, the configurations and the metrics."""
