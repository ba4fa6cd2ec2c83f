"""Data: numpy synthetic registration pairs (copy of the reference's)."""
from .synthetic_pairs import SyntheticPairs  # noqa: F401
