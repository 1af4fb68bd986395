"""The port's copy of the shared two-point estimator
(``tpu_cluster_torch/workloads/timing.py``) against the reference's
(``tpu_cluster/workloads/timing.py``): the same pairs give the same
result dict, exactly (the arithmetic is the same, so no tolerance).
The cases are those of ``tests/test_timing.py``, then a property over
random pair lists."""

import pytest
from hypothesis import given, settings, strategies as st

from tpu_cluster.workloads import timing as ref
from tpu_cluster_torch.workloads import timing as port

E = 1e12
# (pairs, extra_flops, long_flops), as tests/test_timing.py calls them
CASES = {
    "median_with_spread": ([(1.0, 3.1), (1.0, 3.0), (1.0, 2.9)], E, 3 * E),
    "stalled_lo_rejected": ([(1.0, 3.0), (2.95, 3.0), (1.0, 3.1),
                             (1.0, 2.9), (1.05, 3.0)], E, 3 * E),
    "stalled_hi_rejected": ([(1.0, 3.0), (1.0, 4.2), (1.0, 3.1),
                             (1.0, 2.9), (1.0, 3.0)], E, 3 * E),
    "correlated_slow_pair_survives": ([(1.0, 3.0), (1.62, 3.64),
                                       (1.0, 3.1), (1.0, 2.9),
                                       (1.0, 3.0)], E, 3 * E),
    "fewer_than_three_pairs": ([(1.0, 3.0), (5.0, 9.0)], E, 3 * E),
    "all_degenerate_fallback": ([(1.0, 1.0), (9.0, 9.0), (1.1, 1.1)],
                                E, 3 * E),
    "single_pair": ([(1.0, 2.0)], E, 3 * E),
    "mixed_degenerate_excluded": ([(1.0, 1.0005), (1.0, 3.0), (1.0, 3.0)],
                                  E, 3 * E),
}


def test_estimator_name_matches():
    assert port.ESTIMATOR == ref.ESTIMATOR


@pytest.mark.parametrize("pairs,extra,long_flops", CASES.values(),
                         ids=list(CASES))
def test_same_result_as_reference(pairs, extra, long_flops):
    assert port.paired_two_point(pairs, extra, long_flops) == \
        ref.paired_two_point(pairs, extra, long_flops)


_seconds = st.floats(min_value=0.0, max_value=100.0, allow_nan=False,
                     allow_infinity=False)


@settings(max_examples=200, deadline=None)
@given(pairs=st.lists(st.tuples(_seconds, _seconds), min_size=1,
                      max_size=12),
       extra=st.floats(min_value=1.0, max_value=1e16),
       floor=st.sampled_from([1e-3, 0.0, 0.5]),
       tol_frac=st.sampled_from([0.1, 0.0, 0.5]))
def test_same_result_as_reference_on_random_pairs(pairs, extra, floor,
                                                  tol_frac):
    kwargs = dict(floor=floor, stall_tol_frac=tol_frac)
    assert port.paired_two_point(pairs, extra, 3 * extra, **kwargs) == \
        ref.paired_two_point(pairs, extra, 3 * extra, **kwargs)
