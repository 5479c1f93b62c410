"""The benchmark of the PyTorch and CUDA port
(``multimodalworddiscovery_tpu_torch``) on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, one traffic mix, one per-layer metric or one
cell's limits is a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py`` (or the file of its name before the first dot),
``limits/<cell>.json``.  The model families' adapters (``families/``), the
window drivers (``loops/``), the generator copies (``gen/``), the counts of
operations and bytes (``counts/``) and the plain reference
(``reference/``) are the yardstick; nothing here imports JAX or the JAX
package.
"""
