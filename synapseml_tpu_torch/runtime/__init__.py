"""Runtime of the port: the batched executor (``executor.py``), its
executable store and warmup report (``compile_cache.py``), its telemetry
(``telemetry.py``: metrics, spans, the Prometheus exposition), the flight
recorder (``blackbox.py``), structured logging (``structlog.py``), SLO
math (``slo.py``) and fault-injection points (``faults.py``)."""
