"""Saturated serving: a queue kept full from before the window to its
end (``portbench.serve``, a ``saturated`` traffic mix)."""

from portbench.serve import (COMPARED, calibration,  # noqa: F401
                             check_model, run)
