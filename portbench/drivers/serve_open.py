"""Open-loop serving: requests sent when due, whatever the engine does
(``portbench.serve``, an ``open`` traffic mix)."""

from portbench.serve import (COMPARED, calibration,  # noqa: F401
                             check_model, run)
