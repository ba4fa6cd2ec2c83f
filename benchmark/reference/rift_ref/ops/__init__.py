"""Frozen plain copy of the port's modules (see benchmark/reference/__init__.py)."""
