"""Shared once-guard for lazily built, concurrently requested resources
(copy of `echoflow.utils.concurrency`).

The engine builds per-length device operands on first use, possibly from
several threads at once (`segment_videos` stages on a worker thread while
direct `segment_video` calls may arrive from others). A bare
check-then-build races: two threads first-calling the same key both pay a
full build. `get_or_build` makes the first caller install a Future under
the lock and build outside it, so a concurrent second caller blocks on that
Future instead of duplicating the work.
"""

from __future__ import annotations

import concurrent.futures


def get_or_build(cache, lock, key, build, lru_cap: int | None = None):
    """Return `cache[key]`'s value, building it at most once per key.

    The first caller for `key` installs a `Future` in `cache` under `lock`
    and runs `build()` OUTSIDE the lock (a build must not serialize
    unrelated keys); concurrent callers block on that Future. A failed
    build evicts its Future and re-raises, so the key can be retried.

    With `lru_cap`, `cache` must be an `OrderedDict`: hits move to the MRU
    end and inserts evict LRU overflow. A *pending* Future can be evicted
    safely — its builder still resolves it and every waiter holds its own
    reference; the key is simply rebuilt on the next request.
    """
    with lock:
        fut = cache.get(key)
        if fut is not None:
            if lru_cap is not None:
                cache.move_to_end(key)
            builder = False
        else:
            fut = concurrent.futures.Future()
            cache[key] = fut
            if lru_cap is not None:
                while len(cache) > lru_cap:
                    cache.popitem(last=False)
            builder = True
    if not builder:
        return fut.result()
    try:
        result = build()
    except BaseException as e:
        with lock:
            # Evict only OUR Future: after an LRU eviction a newer builder
            # may have re-installed the key, and popping its pending Future
            # would re-open the duplicate-build race this module closes.
            if cache.get(key) is fut:
                cache.pop(key)
        fut.set_exception(e)
        raise
    fut.set_result(result)
    return result
