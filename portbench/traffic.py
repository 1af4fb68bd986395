"""The one generator of serving traffic. A mix is a data file,
``traffic/<name>.json``; this reads it.

Every seed sends the same requests at the same times: sizes and gaps
drawn once from the mix's ``base_seed``, a replayed trace. The seed
draws the prompt ids. Two seeds send the same work; the order is fixed
too, because under an open loop at 4/5 of the knee the order alone moved
the p95 of time to first token by 57% (IQR over median) across six seeds
(PERF.md section 6). So a cell is judged on one fixed trace, and says so
in its ``why``; a second trace is a second mix. A mix names the public
workload its lengths come from (``source``), what it set itself
(``assumed``) and each cut it makes (``reduced``); this module reads
none of those. A mix is either

- ``open``: arrivals on a schedule whatever the engine does, from the
  gaps of ``arrivals`` (``process`` ``poisson``: exponential gaps at
  ``rate_per_s``), starting ``lead_in_s`` before the window; or
- ``saturated``: a queue held at ``queue_depth`` waiting requests from
  before the window to its end.

``prompt`` and ``output`` give the lengths: ``lognormal`` (``median``,
``sigma``) or ``uniform``, clipped to ``[min, max]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np


@dataclass(frozen=True)
class Planned:
    """One request: when it is due (seconds after the schedule starts),
    its prompt ids and how many tokens it asks for."""

    at: float
    prompt: Tuple[int, ...]
    max_new: int


def lengths(rng: np.random.Generator, spec: Dict[str, Any], n: int
            ) -> np.ndarray:
    if spec["dist"] == "lognormal":
        raw = rng.lognormal(math.log(spec["median"]), spec["sigma"], n)
    elif spec["dist"] == "uniform":
        raw = rng.uniform(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(raw), spec["min"], spec["max"]).astype(np.int64)


def count(mix: Dict[str, Any], seconds: float) -> int:
    """Requests to plan: a saturated mix's fixed pool; for an open one,
    enough for the lead-in, the window and the longest drain."""
    if mix["kind"] == "saturated":
        return int(mix["requests"])
    span = mix["arrivals"]["lead_in_s"] + seconds + mix["drain_s"]
    return int(math.ceil(mix["arrivals"]["rate_per_s"] * span))


def gaps(rng: np.random.Generator, arrivals: Dict[str, Any], n: int
         ) -> np.ndarray:
    rate = arrivals["rate_per_s"]
    if arrivals["process"] == "poisson":
        return rng.exponential(1.0 / rate, n)
    if arrivals["process"] == "gamma":
        shape = 1.0 / arrivals["cv"] ** 2
        return rng.gamma(shape, 1.0 / (rate * shape), n)
    raise ValueError(f"unknown arrival process {arrivals['process']!r}")


def _stream(base: int, which: int) -> np.random.Generator:
    """One of the trace's streams (prompt lengths, output lengths, gaps),
    each of its own: the first requests are the same however many are
    planned, and another rate only scales the same gaps."""
    return np.random.default_rng([base, which])


def plan(mix: Dict[str, Any], seed: int, seconds: float, vocab: int,
         context: int) -> List[Planned]:
    """The run's requests, in the order they are sent."""
    n = count(mix, seconds)
    base = int(mix["base_seed"])
    prompt = lengths(_stream(base, 0), mix["prompt"], n)
    output = lengths(_stream(base, 1), mix["output"], n)
    if mix["kind"] == "open":
        gap = gaps(_stream(base, 2), mix["arrivals"], n)
    elif mix["kind"] == "saturated":
        gap = np.zeros(n)
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    if int((prompt.max() + output.max())) >= context:
        raise ValueError(f"prompt + output reach {prompt.max() + output.max()}"
                         f", past the context {context}")
    at = np.cumsum(gap)
    rng = np.random.default_rng(int(seed))
    ids = rng.integers(0, vocab, int(prompt.sum()))
    ends = np.cumsum(prompt)
    return [Planned(at=float(at[i]),
                    prompt=tuple(ids[ends[i] - prompt[i]:ends[i]].tolist()),
                    max_new=int(output[i]))
            for i in range(n)]
