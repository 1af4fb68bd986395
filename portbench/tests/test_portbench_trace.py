"""The reduction of a trace: idle gaps named by the innermost host
operation that ran in them."""

from __future__ import annotations

import pytest

from portbench import trace


def test_gaps_by_host_operation():
    gaps = [(10, 20), (30, 40), (50, 60)]
    host = [(0, 100, "outer"), (28, 45, "aten::copy_")]
    out = trace._label_gaps(gaps, host)
    assert out == pytest.approx({"outer": 20e-9, "aten::copy_": 10e-9})
    assert trace._label_gaps([(0, 5)], []) == pytest.approx({"python": 5e-9})

