"""The benchmark of the PyTorch and CUDA port (``dpe_mvs_tpu_torch``).

``python3 mvs_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see ``run.py``.
Nothing here imports JAX or the JAX package.
"""
