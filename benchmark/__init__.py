"""The benchmark of ``gennbv_tpu_torch`` (the PyTorch / CUDA port): cells,
metrics and bounds in ``BENCHMARK.json``; one run of one cell with

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

on a CUDA card.  A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` (run by ``loops/<loop>.py``), a per-layer
metric ``metrics/<name>.py``, a cell's limits ``limits/<workload>.json``;
the plain reference that decides ``correct`` is ``reference/``, the
frozen counts ``work/``.  Nothing here imports JAX or the JAX package.
"""
