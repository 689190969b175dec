"""Runtime of the port: the batched executor (``executor.py``), its
executable store and warmup report (``compile_cache.py``), its telemetry
(``telemetry.py``) and fault-injection points (``faults.py``)."""
