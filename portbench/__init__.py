"""The benchmark of ``dctpu_torch``, the PyTorch and CUDA port of the codec.

  python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name under this folder: the
configuration in ``configs/<config>.json``, the traffic mix in
``traffic/<traffic>.json``, each per-layer metric's reader in
``metrics/<metric>.py``; ``BENCHMARK.json`` at the checkout's root names
them. ``pending/<cell>.json`` holds the entries of a cell made but left
out of ``BENCHMARK.json``, with the reason. The yardstick lives here too: the generator of the inputs, the plain
reference encoder (``reference/``), the operation and byte counts of each
kernel (``work.py``) and the reduction of the profiler's trace
(``trace.py``). Nothing here imports JAX or the JAX package.
"""
