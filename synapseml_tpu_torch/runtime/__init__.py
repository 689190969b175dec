"""Runtime of the port: the batched executor (``executor.py``), its
telemetry (``telemetry.py``) and fault-injection points (``faults.py``)."""
