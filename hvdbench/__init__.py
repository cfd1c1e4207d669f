"""The benchmark of ``horovod_tpu_torch``: data-parallel training cells
driven by ``BENCHMARK.json``.  Entry point: ``python3 hvdbench/run.py``.
"""
