"""Correspondence-pair hashing / row-set utilities: a copy of
`rift_tpu/utils/pair_hash.py` (numpy only).

Equivalent of the reference's FCGF-style helpers
(`utils/hash_external.py:4-32`): polynomial row hashes for (idx1, idx2)
correspondence pairs, row membership, and set-difference filtering — used
to dedupe correspondence sets across passes. The reference's
`filter_intersection` loops `find_row` per row (O(n1·n2·m) Python); here
membership is one vectorized comparison via the same hash.
"""
from __future__ import annotations

import numpy as np


def hash_rows(arr: np.ndarray, seed: int) -> np.ndarray:
    """Polynomial row hash: sum_d arr[:, d] * seed**d (ref `_hash`).

    Computed in uint64 with intentional modular wraparound: with large
    seeds (filter_intersection uses 1_000_003) seed**k overflows 64 bits
    for row widths D >= 4; modular arithmetic keeps the hash well-defined
    (equal rows always hash equal; collisions are resolved by the exact
    row check in `filter_intersection`)."""
    arr = np.asarray(arr)
    n, d = arr.shape
    out = np.zeros(n, dtype=np.uint64)
    power = np.uint64(1)
    seed_u = np.uint64(np.int64(seed))
    with np.errstate(over="ignore"):
        for k in range(d):
            out += arr[:, k].astype(np.int64).astype(np.uint64) * power
            power = power * seed_u
    return out


def hash_pairs(idx1: np.ndarray, idx2: np.ndarray, seed: int = 97
               ) -> np.ndarray:
    """Hash key per correspondence pair (ref `get_hash_key_for_pairs`)."""
    return hash_rows(np.stack([np.asarray(idx1), np.asarray(idx2)], axis=1),
                     seed)


def find_row(row: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Indices of rows of `mat` equal to `row` (ref `find_row`)."""
    return np.where((np.asarray(row) == np.asarray(mat)).all(1))[0]


def filter_intersection(source: np.ndarray, existing: np.ndarray
                        ) -> np.ndarray:
    """Rows of `source` NOT present in `existing` (ref
    `filter_intersection`, vectorized: hash-bucketed membership with an
    exact row check to rule out collisions)."""
    source = np.asarray(source)
    existing = np.asarray(existing)
    if len(existing) == 0 or len(source) == 0:
        return source
    seed = 1_000_003
    hs = hash_rows(source, seed)
    he = hash_rows(existing, seed)
    maybe = np.isin(hs, he)
    keep = ~maybe
    # exact check for hash-positive rows only
    for i in np.where(maybe)[0]:
        if len(find_row(source[i], existing)) == 0:
            keep[i] = True
    return source[keep]
