"""Open-loop serving: requests sent when due, whatever the engine does
(``portbench.serve``, an ``open`` traffic mix)."""

from portbench.serve import run  # noqa: F401
