"""svd.plan_cache_misses (count): misses of the engine's geometry cache
(``SvdEngine.cache_info``, the ``engine_plan_cache_misses`` count) over the
traced window; 0 once the cell's shapes are warm."""


def read(rec):
    return rec.get("plan_cache_misses")
