"""Set operations on host arrays, by sort.

numpy 2.3 finds the distinct values of an integer array with a hash table
and sorts them after.  On 85 M int64 keys of a Reddit-size graph that
took 239 s on the H100 machine's host, where a sort and a mask take 1.8 s
(``bench_torch/unique_probe.py`` times both).  The plan builders, the graph
generators and the examples call :func:`sorted_unique` in place of
``np.unique(a)``; forms with ``return_index``, ``return_inverse`` or
``return_counts`` sort in every numpy and stay as they are.
"""
from __future__ import annotations

import numpy as np


def sorted_unique(a) -> np.ndarray:
    """``np.unique(a)`` for an integer or boolean array: its distinct
    values, flattened, in ascending order."""
    s = np.sort(np.asarray(a).ravel())
    if s.size < 2:
        return s
    keep = np.empty(s.size, bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]
