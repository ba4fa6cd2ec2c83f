"""Frozen plain copy of the port's modules (`benchmark/reference/__init__.py`). The
modules keep the port's docstrings; where one names a hand-written kernel,
this copy runs its plain version (`ops/plain/`)."""
