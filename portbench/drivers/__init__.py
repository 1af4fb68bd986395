"""One driver per kind of cell, found by the name a cell gives. Each has
``run``, ``calibration``, ``COMPARED`` and ``check_model`` (``harness``'s
docstring says what each is)."""
