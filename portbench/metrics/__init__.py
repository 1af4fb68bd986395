"""One reader per metric of ``BENCHMARK.json``, ``read(record)``: the
metric's value from the run's record, or ``None`` where the record holds
nothing it reads."""
