"""Stream traffic in a fixed order: `drivers/stream.py`'s run (pool, set-up,
window, end-to-end metrics, checks and controls), except that the stream
hands the engine the pool's videos in one order that the run's seed does
not choose: one permutation of the pool (`ORDER_SEED`'s), the same in
every run and repeated for every pass. The seed still draws every video's
beat, the checked videos and the weights.

Over a pool of many lengths (`archive-anylen`: 193) the order decides
which lengths' operands and graph keys meet in the engine's bounded caches
(64 operand slots, 8 graphs), and so where the window's warm-ups,
captures and operand builds fall and which graphs share the card's
memory at once. With a per-seed order `peak_reserved_gib` spread 6.4% over
6 seeds on an NVIDIA H100 80GB HBM3; in one order it read the same on
every seed. `frames_per_s` spreads in either order (host-bound rebuilds in
the window), and the cell does not report it.
"""

from __future__ import annotations

import numpy as np

from portbench.drivers import stream

ORDER_SEED = 1   # the one order's


class _FixedOrder:
    """The pool's generator, but `permutation` gives the one order each
    time."""

    def __init__(self, rng):
        self._rng = rng

    def permutation(self, n):
        return np.random.default_rng([3, ORDER_SEED]).permutation(n)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def run(cell):
    make_pool = stream.make_pool

    def fixed(traffic, seed):
        pool, rng = make_pool(traffic, seed)
        return pool, _FixedOrder(rng)

    stream.make_pool = fixed
    try:
        return stream.run(cell)
    finally:
        stream.make_pool = make_pool
