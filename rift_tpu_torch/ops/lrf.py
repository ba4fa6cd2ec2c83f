"""Local reference frames: the 'change_coords' rotation-invariant preprocess.

Twin of `rift_tpu/ops/lrf.py` (`global_lrf`, `local_lrf`, `pca_lrf`,
`lrf_basis`, `change_coords`, `lrf_flip_hypotheses`, `pca_align`). Bases
are [..., 3, 3] with ROWS = axes; canonical coordinates are coords @ basisᵀ.
"""
from __future__ import annotations

import torch

from .. import tracing
from .eig3 import eigh_sym3

Tensor = torch.Tensor

_COLLINEAR = 0.9
_NORM_EPS = 1e-5


def _unit(v: Tensor, eps: float = 1e-12) -> Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def _pick_base_y(units: Tensor, norms: Tensor, base_x: Tensor) -> Tensor:
    """First point in rank order with norm > 1e-5 and |cos| < 0.9 (the
    last candidate when none qualifies)."""
    lam = (units * base_x[..., None, :]).sum(-1)
    ok = (norms > _NORM_EPS) & (lam.abs() < _COLLINEAR)
    n = units.shape[-2]
    first = torch.argmax(ok.to(torch.uint8), dim=-1)  # first True
    j = torch.where(ok.any(-1), first, torch.full_like(first, n - 1))
    return torch.gather(units, -2, j[..., None, None].expand(j.shape + (1, 3)))[..., 0, :]


def global_lrf(coords: Tensor) -> Tensor:
    """The reference's farthest-point LRF of a centered cloud [..., n, 3]."""
    norms = torch.linalg.vector_norm(coords, dim=-1)
    order = torch.argsort(-norms, dim=-1, stable=True)
    sorted_pts = torch.gather(coords, -2, order[..., None].expand(coords.shape))
    sorted_norms = torch.gather(norms, -1, order)
    units = sorted_pts / torch.clamp(sorted_norms[..., None], min=1e-20)
    base_x = units[..., 0, :]
    base_y = _pick_base_y(units, sorted_norms, base_x)
    base_x = _unit(base_x - base_y * (base_x * base_y).sum(-1, keepdim=True))
    base_z = _unit(torch.linalg.cross(base_x, base_y))
    return torch.stack([base_x, base_y, base_z], dim=-2)


def local_lrf(neighbor_coords: Tensor) -> Tensor:
    """Each neighbourhood [..., n, k, 3] in its own LRF -> [..., n, k, 3]:
    centred by its mean, base_x the farthest point (the first on ties),
    base_y the first non-collinear one down the norm ranking, then base_y
    orthogonalized against base_x (the global frame's order reversed) and
    base_z = x × y. The centred points are projected in their own order."""
    centered = neighbor_coords - neighbor_coords.mean(-2, keepdim=True)
    norms = torch.linalg.vector_norm(centered, dim=-1)
    order = torch.argsort(-norms, dim=-1, stable=True)
    sorted_pts = torch.gather(centered, -2, order[..., None].expand(centered.shape))
    sorted_norms = torch.gather(norms, -1, order)
    units = sorted_pts / torch.clamp(sorted_norms[..., None], min=1e-20)
    base_x = units[..., 0, :]
    base_y = _pick_base_y(units, sorted_norms, base_x)
    base_y = _unit(base_y - base_x * (base_x * base_y).sum(-1, keepdim=True), 1e-10)
    base_z = _unit(torch.linalg.cross(base_x, base_y))
    basis = torch.stack([base_x, base_y, base_z], dim=-2)
    return torch.matmul(centered, basis.transpose(-1, -2))


def pca_lrf(coords: Tensor) -> Tensor:
    """PCA axes by descending eigenvalue, each signed by the third moment of
    the cloud along it, third axis = x × y. coords [..., n, 3] -> [..., 3, 3].

    `torch.linalg.eigh` is safe here: every column's sign is re-fixed from
    the data, so its vector convention does not reach the result.
    """
    centered = coords - coords.mean(-2, keepdim=True)
    cov = torch.matmul(centered.transpose(-1, -2), centered) / centered.shape[-2]
    tracing.count("host.syncs")                # eigh reads its error codes on the host
    _, vecs = torch.linalg.eigh(cov)           # ascending eigenvalues
    vecs = vecs.flip(-1)                       # columns, descending
    proj = torch.matmul(centered, vecs)
    m3 = (proj ** 3).mean(-2)
    sign = torch.where(m3 >= 0, torch.ones_like(m3), -torch.ones_like(m3))
    vecs = vecs * sign[..., None, :]
    vx, vy = vecs[..., :, 0], vecs[..., :, 1]
    return torch.stack([vx, vy, torch.linalg.cross(vx, vy)], dim=-2)


def lrf_flip_hypotheses(basis: Tensor) -> Tensor:
    """The 4 right-handed sign assignments of a basis [..., 3, 3] (rows =
    axes) -> [..., 4, 3, 3]: (+,+,+), (+,-,-), (-,+,-), (-,-,+). A proper
    rotation flips an even number of axes, so these are all the frames a
    sign-ambiguous orthogonal frame can take."""
    eye = torch.eye(3, dtype=basis.dtype, device=basis.device)
    flips = torch.cat([torch.ones_like(eye[:1]), 2.0 * eye - 1.0])  # [4, 3], made on the device
    return basis[..., None, :, :] * flips[:, :, None]


def lrf_basis(coords: Tensor, kind: str = "reference") -> Tensor:
    """'reference' -> `global_lrf`, 'pca' -> `pca_lrf`."""
    if kind == "reference":
        return global_lrf(coords)
    if kind == "pca":
        return pca_lrf(coords)
    raise ValueError(f"unknown lrf kind {kind!r}")


def change_coords(coords: Tensor, basis: Tensor | None = None) -> Tensor:
    """Canonicalize a centered cloud [..., n, 3] into `basis` (rows = axes;
    the reference LRF when None)."""
    if basis is None:
        basis = global_lrf(coords)
    return torch.matmul(coords, basis.transpose(-1, -2))


def pca_align(coords: Tensor) -> Tensor:
    """The 'pca' preprocess: the centred cloud [..., n, 3] in the axes of
    its scatter matrix Σ cᵢcᵢᵀ, by descending eigenvalue. Each axis has a
    sign of its own choosing in either package: here `ops/eig3.py:
    eigh_sym3`'s (closed form, no host sync), in the reference LAPACK's."""
    centered = coords - coords.mean(-2, keepdim=True)
    cov = torch.matmul(centered.transpose(-1, -2), centered)
    _, vecs = eigh_sym3(cov)            # columns, ascending eigenvalues
    return torch.matmul(centered, vecs.flip(-1))
