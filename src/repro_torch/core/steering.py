"""Request preparation & steering: the round/budget split (rate limiter).

Only :func:`num_rounds` is ported so far; route programs and their
constructors come with the next slice.
"""
from __future__ import annotations


def num_rounds(num_requests: int, budget: int) -> int:
    """Static round count for ``num_requests`` at ``budget`` pages/round."""
    if num_requests == 0:
        return 0
    return -(-num_requests // max(budget, 1))
