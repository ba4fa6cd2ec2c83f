"""Data: numpy synthetic registration pairs and the synthetic ModelNet40
split (copies of the reference's)."""
from .modelnet40 import ModelNet40, ModelNet40Config, get_datasets  # noqa: F401
from .synthetic_pairs import PairBatch, SyntheticPairs, get_pairs  # noqa: F401
