"""The benchmark of the PyTorch/CUDA port (``multimodal_embedding_tpu_torch``).

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the card:

    python3 -m perfbench.run --workload clip-l.coco-encode --seed 7 --seconds 20 --trace 0

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell lives in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (which names its driver,
``drivers/<driver>.py``), ``metrics/<metric>.py`` and ``limits/<cell>.json``.
``reference/`` is the plain PyTorch reference that decides ``correct``; it
imports nothing of the port. Nothing here imports JAX or the JAX package.
"""
