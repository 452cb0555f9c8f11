"""Per-layer metric readers, one file a metric, named as in BENCHMARK.json.
Each defines ``read(ctx) -> float | None`` (None: nothing to read here)."""
