"""plan_cache_hit_pct: the plan cache's hits over its lookups in the window
(``PlanCache.counters()`` before and after); None without a lookup."""


def read(reading):
    before, after = reading["plan_cache"]["before"], reading["plan_cache"]["after"]
    hits = after["hits"] - before["hits"]
    looks = hits + after["misses"] - before["misses"]
    return 100.0 * hits / looks if looks else None
