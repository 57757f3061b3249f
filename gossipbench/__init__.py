"""The benchmark of ``bluefog_tpu_torch``: one cell a run, found by name in
``BENCHMARK.json`` (see ``README.md``)."""
