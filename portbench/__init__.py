"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA H100s.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Configurations,
traffic mixes, traffic drivers, per-layer metrics, references and limits are
files found by name (``spec``); nothing here imports JAX or the JAX package.
"""
