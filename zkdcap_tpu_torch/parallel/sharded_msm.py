"""Multi-shard Pippenger MSM: points split over the shards, partials folded.

Port of ``zkdcap_tpu/parallel/sharded_msm.py``. The points, and the scalars
made standard with ``from_mont``, split into one equal block per shard of
the mesh; each shard runs the single-device MSM of ``msm/pippenger.py`` on
its block (``msm_ladder`` at or under ``SMALL_MSM_MAX`` points, else
``msm_device``: kernels B, C, D, and F under the sort switches). The
partials, one projective point per shard, are gathered on the first shard
and folded in log depth with kernel C. EC addition is not a ring sum, so the
combine is this gathered fold, not a reduction collective.

Ladder-sized blocks of shards that share a device, and of every polynomial
of one round's commitments, run as one batched ladder (one launch of
kernel C per step for all of them), as ``msm_many_host`` batches a round's
polynomials on one device; above the ladder, each shard runs one
``msm_device`` per polynomial, as the JAX package does. On distinct devices
the shards interleave (``Mesh.map``): each ``msm_device`` runs as steps
that end before its reads of the Hillis-Steele levels, so every card is
given its work up to its next read before the host waits on any; the cards
then overlap as far as a card's work outlasts the host's issue. The SRS
blocks of each shard are cached on the mesh per (SRS, prefix length): a
proof's commitments then copy no points between cards.
"""

from __future__ import annotations

import torch

from ..curves.device_g1 import G1_SPEC, CurveSpec, Point
from ..fields import mont
from ..fields.params import BN254_FR
from ..msm.pippenger import SMALL_MSM_MAX, _pad_rows, _tree_sum, msm_device_steps, msm_ladder
from .mesh import Mesh, _is_mesh


def _local_partials(mesh: Mesh, spec: CurveSpec, pts: list[torch.Tensor],
                    std: list[list[torch.Tensor]]) -> list[torch.Tensor]:
    """pts[shard] (b, 2, 16), std[poly][shard] (b, 16) -> each shard's MSMs
    as (polys, 3, 16) projective points on its device, the shards on
    distinct devices interleaved step by step (``Mesh.map``)."""
    b = pts[0].shape[0]
    if b > SMALL_MSM_MAX:
        n_pow = 1 << (b - 1).bit_length()
        lanes = min(16384, n_pow)

        def shard(p, scalars):  # steps: Mesh.map issues the other shards at each read
            parts = []
            for s in scalars:
                R = yield from msm_device_steps(spec, _pad_rows(p, n_pow), _pad_rows(s, n_pow),
                                                lanes)
                parts.append(torch.stack(R))
            return torch.stack(parts)

        return mesh.map(shard, pts, list(zip(*std)))
    by_device: dict[torch.device, list[int]] = {}
    for i, p in enumerate(pts):
        by_device.setdefault(p.device, []).append(i)

    def ladder(idx):
        X, Y, Z = msm_ladder(spec, torch.stack([pts[i] for i in idx]),
                             torch.stack([torch.stack([s[i] for i in idx]) for s in std]))
        return [torch.stack([X[:, j], Y[:, j], Z[:, j]], 1) for j in range(len(idx))]

    out: list[torch.Tensor | None] = [None] * len(pts)
    groups = list(by_device.values())
    for idx, parts in zip(groups, mesh.map(ladder, groups, devices=list(by_device))):
        for i, part in zip(idx, parts):
            out[i] = part
    return out


def sharded_msm_many(mesh: Mesh, points: torch.Tensor, scalars_list,
                     spec: CurveSpec = G1_SPEC) -> list[Point]:
    """The MSMs of the first m points (int32[>= m, 2, 16] affine Montgomery,
    an SRS's G1 powers) with each scalar vector ((<= m, 16) Montgomery Fr,
    zero-padded to m), all on the mesh's first shard; m, the longest
    vector, a multiple of the mesh size. Returns one projective point per
    vector (three (16,) tensors on the first shard), the group element
    ``msm`` gives on one device. The shards' blocks of ``points[:m]`` are
    cached on the mesh while ``points`` lives."""
    mesh = _is_mesh(mesh)
    m = max(s.shape[0] for s in scalars_list)
    if m > points.shape[0]:
        raise ValueError(f"{m} scalars for {points.shape[0]} points")
    if m % mesh.size:
        raise ValueError(f"N={m} not divisible by {mesh.size} shards")
    pts = mesh.cached(points, ("points", m), lambda: mesh.split(points[:m]))
    std = [mesh.split(_pad_rows(mont.from_mont(BN254_FR, s), m)) for s in scalars_list]
    # (shards, polys, 3, 16)
    parts = torch.stack(mesh.all_gather(_local_partials(mesh, spec, pts, std)))
    X, Y, Z = _tree_sum(spec, tuple(parts[:, :, i] for i in range(3)), 0)
    return [(X[k], Y[k], Z[k]) for k in range(len(scalars_list))]


def sharded_msm(mesh: Mesh, points: torch.Tensor, scalars_mont: torch.Tensor,
                spec: CurveSpec = G1_SPEC) -> Point:
    """One MSM of :func:`sharded_msm_many`: the first m points with m
    scalars."""
    return sharded_msm_many(mesh, points, [scalars_mont], spec)[0]
