"""Sparse-voxel and position-adaptive conv ops, the port of
point_cloud_reid_tpu/ops/sparse.py in plain PyTorch.

  assign_score_withk      PAConv's weight-bank score assembly
  build_indice_pairs      spconv's submanifold rulebook
  submanifold_conv3d      SubMConv3d (output sites == input sites)
  build_strided_output    the output sites of a strided op
  sparse_conv3d           SparseConv3d (subm=False)
  sparse_inverse_conv3d   SparseInverseConv3d over its couple's pairs
  sparse_maxpool3d        SparseMaxPool3d
  to_dense                ToDense (channel-last)

Voxel sets have a fixed capacity (padded rows and a validity mask). The JAX
package builds its rulebook with a sequential open-addressing hash: rows
are inserted in order, each into the first empty slot among the
_PROBES = 64 after its hash, and an insert that finds none is dropped.
Here the same rulebook comes from sorting: _insert_ok decides which
inserts the probe budget drops, and a lookup returns what the JAX table
returns, the lowest inserted row of equal coordinates or -1. Output sites
of strided ops take their slots in first-occurrence order, up to
`capacity`, as the JAX counter gives them. Pairs, site order and the
overflow behaviour (a full table, a full probe window, more sites than
capacity) are the same index for index.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_PROBES = 64   # linear-probing budget of the JAX package's hash
_MASK32 = 0xFFFFFFFF


def assign_score_withk(scores: torch.Tensor, points: torch.Tensor,
                       centers: torch.Tensor, knn_idx: torch.Tensor,
                       aggregate: str = "sum") -> torch.Tensor:
    """PAConv score-weighted kernel assembly.

    scores (B, N, K, M) over M weight banks; points and centers
    (B, Npoint, M, O) features pre-multiplied by each bank; knn_idx
    (B, N, K) into Npoint. Returns (B, N, K, O):
        out[b, n, k] = agg_m scores[b, n, k, m]
                       * (points[b, idx[b, n, k], m] - centers[b, n, m])
    with agg 'sum', 'avg' (sum / M) or 'max'."""
    B, N, K, M = scores.shape
    rows = torch.arange(B, device=points.device)[:, None]
    gathered = points[rows, knn_idx.reshape(B, N * K).long()].reshape(
        B, N, K, M, points.shape[-1])
    diff = gathered - centers[:, :, None]
    if aggregate in ("sum", "avg"):
        out = torch.einsum("bnkm,bnkmo->bnko", scores, diff)
        return out if aggregate == "sum" else out / M
    if aggregate == "max":
        return torch.amax(scores[..., None] * diff, dim=3)
    raise ValueError(aggregate)


def _coord_hash(c: torch.Tensor, size: int) -> torch.Tensor:
    """(..., 3) integer coordinates -> (...) int64 slots in [0, size): the
    JAX package's uint32 hash (x * 73856093 ^ y * 19349663 ^ z * 83492791
    mod 2^32, then mod size), in int64 arithmetic."""
    u = c.long() & _MASK32
    x = (((u[..., 0] * 73856093) & _MASK32)
         ^ ((u[..., 1] * 19349663) & _MASK32)
         ^ ((u[..., 2] * 83492791) & _MASK32))
    return x % size


def _simulate(h: np.ndarray, size: int, rows: np.ndarray,
              ok: np.ndarray) -> None:
    """Insert items `rows` (in order) one by one as the JAX hash does, into
    a table of `size` slots that holds nothing else, marking in `ok` the
    ones that find an empty slot within _PROBES."""
    full = np.zeros(size, bool)
    for i in rows:
        s = h[i]
        for j in range(_PROBES):
            t = (s + j) % size
            if not full[t]:
                full[t] = ok[i] = True
                break


def _insert_ok(h: torch.Tensor, size: int) -> torch.Tensor:
    """(n,) bool: which of the n inserts, made in order into an empty table
    of `size` slots at hash slots h (n,), find an empty slot within
    _PROBES probes (the rest are dropped, as in the JAX hash).

    With _PROBES >= size the probes see the whole table, so the first
    `size` inserts land. Otherwise, while fewer items than slots are
    inserted, the occupied slots of linear probing without a budget do not
    depend on the order, and an item never leaves the run of occupied
    slots its hash falls in: every item whose run is at most _PROBES long
    lands. Only the items of longer runs are inserted one by one, run by
    run independent of the others."""
    n = h.numel()
    dev = h.device
    if size <= _PROBES:
        return torch.arange(n, device=dev) < size
    ok = np.zeros(n, bool)
    if n < size:
        counts = torch.bincount(h, minlength=size)
        # carry of unplaced items past each slot, twice round the table:
        # the second round is exact, since some slot stays empty
        prefix = torch.cumsum((counts - 1).repeat(2), 0)
        carry = prefix - torch.clamp(torch.cummin(prefix, 0).values, max=0)
        carry_in = carry[size - 1:2 * size - 1]
        occupied = (carry_in + counts) >= 1
        # runs of occupied slots, from an empty slot on
        e = int(torch.nonzero(~occupied)[0])
        occ = torch.roll(occupied, -e)
        start = occ.clone()
        start[1:] &= ~occ[:-1]
        run = torch.cumsum(start.long(), 0)
        length = torch.bincount(run[occ], minlength=int(run[-1]) + 1)
        long_run = torch.zeros(size, dtype=torch.bool, device=dev)
        long_run[occ] = length[run[occ]] > _PROBES
        hard = torch.roll(long_run, e)[h]
        if not bool(hard.any()):
            return torch.ones(n, dtype=torch.bool, device=dev)
        ok = (~hard).cpu().numpy()
        _simulate(h.cpu().numpy(), size,
                  np.nonzero(hard.cpu().numpy())[0], ok)
    else:
        _simulate(h.cpu().numpy(), size, np.arange(n), ok)
    return torch.from_numpy(ok).to(dev)


def _row_keys(*coords: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One int64 key per (..., 3) coordinate row, equal exactly where the
    rows are equal, across all the arrays given."""
    flat = [c.reshape(-1, 3).long() for c in coords]
    cat = torch.cat(flat)
    if cat.shape[0] == 0:
        return tuple(torch.zeros(f.shape[0], dtype=torch.long,
                                 device=cat.device) for f in flat)
    lo = cat.amin(0)
    span = [int(v) for v in (cat.amax(0) - lo + 1).tolist()]
    if span[0] * span[1] * span[2] < 2 ** 62:
        c = cat - lo
        keys = (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
    else:
        keys = torch.unique(cat, dim=0, return_inverse=True)[1]
    return tuple(torch.split(keys, [f.shape[0] for f in flat]))


def _hash_build(coords: torch.Tensor, valid: torch.Tensor, size: int):
    """The rows a JAX hash table of `size` slots holds after inserting the
    valid rows of coords (V, 3) in order: (their coordinates, their row
    indices), the dropped inserts left out."""
    rows = torch.nonzero(valid.bool()).reshape(-1)
    ok = _insert_ok(_coord_hash(coords[rows], size), size)
    rows = rows[ok]
    return coords[rows], rows


def _hash_lookup(table, queries: torch.Tensor) -> torch.Tensor:
    """(..., 3) queries -> (...) int64 row of the table (from _hash_build)
    with those coordinates, the lowest such row, or -1."""
    table_coords, table_rows = table
    kt, kq = _row_keys(table_coords, queries)
    out = torch.full_like(kq, -1)
    if kt.numel():
        order = torch.sort(kt, stable=True).indices
        ks, rs = kt[order], table_rows[order]
        pos = torch.clamp(torch.searchsorted(ks, kq), max=ks.numel() - 1)
        out = torch.where(ks[pos] == kq, rs[pos], out)
    return out.reshape(queries.shape[:-1])


def build_indice_pairs(coords: torch.Tensor, valid: torch.Tensor,
                       kernel_offsets: torch.Tensor,
                       hash_size: Optional[int] = None) -> torch.Tensor:
    """Submanifold neighbour table: (V, P) int64, for each active voxel and
    kernel offset (P, 3) the row of the active voxel at coords + offset, or
    -1 (absent, an invalid row, or an insert the hash dropped). The hash
    has hash_size slots, by default max(2V, 16)."""
    V = coords.shape[0]
    table = _hash_build(coords, valid, hash_size or max(2 * V, 16))
    pairs = _hash_lookup(table, coords[:, None, :] + kernel_offsets[None])
    return torch.where(valid.bool()[:, None], pairs, -1)


def _centered_offsets(k: int, device) -> torch.Tensor:
    r = (k - 1) // 2
    ax = torch.arange(-r, r + 1, device=device)
    return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3).to(torch.int32)


def _corner_offsets(kernel_size: int, device) -> torch.Tensor:
    """(k^3, 3) offsets in corner convention: out * s - p + off == in."""
    ax = torch.arange(kernel_size, device=device)
    return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3).to(torch.int32)


def _gather_conv(features: torch.Tensor, pairs: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """sum_p weights[p]^T features[pairs[:, p]] over the present taps."""
    mask = pairs >= 0
    gathered = features[torch.clamp(pairs, min=0)] * mask[..., None]
    return torch.einsum("vpc,pcd->vd", gathered, weights)


def submanifold_conv3d(features: torch.Tensor, coords: torch.Tensor,
                       valid: torch.Tensor, weights: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Submanifold sparse 3D conv over a fixed-capacity voxel set: features
    (V, Cin), coords (V, 3), valid (V,), weights (P, Cin, Cout) over the
    P = k^3 centred offsets (ij order), bias (Cout,). Returns (V, Cout),
    zero on invalid rows."""
    P = weights.shape[0]
    k = int(round(P ** (1 / 3)))
    pairs = build_indice_pairs(coords, valid,
                               _centered_offsets(k, coords.device))
    out = _gather_conv(features, pairs, weights)
    if bias is not None:
        out = out + bias
    return out * valid[:, None]


def build_strided_output(coords: torch.Tensor, valid: torch.Tensor,
                         kernel_size: int, stride: int, padding: int,
                         capacity: int,
                         spatial_shape: Optional[Sequence[int]] = None):
    """Output sites of a strided sparse op: the distinct o >= 0 (and below
    the output shape when spatial_shape is given) with o * stride -
    padding + offset on an active input, in first-occurrence order over
    (input row, offset), at most `capacity` of them.

    Returns out_coords (capacity, 3) int32 (zero rows past the last site),
    out_valid (capacity,) bool, and pairs (capacity, P) int64 rows of the
    input at out_coords * stride - padding + offs[p], -1 where absent."""
    dev = coords.device
    offs = _corner_offsets(kernel_size, dev)
    cand = coords[:, None, :] + padding - offs[None]
    ok = (valid.bool()[:, None] & torch.all(cand % stride == 0, -1)
          & torch.all(cand >= 0, -1))
    out = torch.div(cand, stride, rounding_mode="floor")
    if spatial_shape is not None:
        out_shape = torch.tensor(
            [(d + 2 * padding - kernel_size) // stride + 1
             for d in spatial_shape], dtype=out.dtype, device=dev)
        ok &= torch.all(out < out_shape, -1)
    sites = out.reshape(-1, 3)[ok.reshape(-1)]

    # distinct sites in first-occurrence order
    (keys,) = _row_keys(sites)
    uniq, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((uniq.numel(),), sites.shape[0], dtype=torch.long,
                       device=dev)
    first.scatter_reduce_(0, inv, torch.arange(sites.shape[0], device=dev),
                          "amin")
    sites = sites[torch.sort(first).values]

    # the JAX counter-allocating insert: a site the probe window drops
    # takes no slot
    size = max(4 * capacity, 16)
    placed = _insert_ok(_coord_hash(sites, size), size)
    sites = sites[placed][:capacity]
    n_out = sites.shape[0]
    out_coords = torch.zeros((capacity, 3), dtype=torch.int32, device=dev)
    out_coords[:n_out] = sites.to(torch.int32)
    out_valid = torch.arange(capacity, device=dev) < n_out

    V = coords.shape[0]
    table = _hash_build(coords, valid, max(2 * V, 16))
    queries = out_coords[:, None, :] * stride - padding + offs[None]
    pairs = _hash_lookup(table, queries)
    return out_coords, out_valid, torch.where(out_valid[:, None], pairs, -1)


def sparse_conv3d(features: torch.Tensor, coords: torch.Tensor,
                  valid: torch.Tensor, weights: torch.Tensor,
                  stride: int = 2, padding: int = 1,
                  bias: Optional[torch.Tensor] = None,
                  capacity: Optional[int] = None,
                  spatial_shape: Optional[Sequence[int]] = None):
    """Strided sparse 3D conv (spconv SparseConv3d, subm=False): weights
    (P, Cin, Cout) over the k^3 corner offsets; capacity defaults to the
    exact worst case V * ceil(k / stride)^3. Returns (out_features
    (capacity, Cout), out_coords, out_valid, pairs); pairs feed the couple
    sparse_inverse_conv3d."""
    P = weights.shape[0]
    k = int(round(P ** (1 / 3)))
    capacity = capacity or coords.shape[0] * (-(-k // stride)) ** 3
    out_coords, out_valid, pairs = build_strided_output(
        coords, valid, k, stride, padding, capacity, spatial_shape)
    out = _gather_conv(features, pairs, weights)
    if bias is not None:
        out = out + bias
    return out * out_valid[:, None], out_coords, out_valid, pairs


def sparse_inverse_conv3d(features: torch.Tensor, pairs: torch.Tensor,
                          weights: torch.Tensor, n_out: int,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Inverse sparse conv (spconv SparseInverseConv3d) over the couple
    strided conv's pairs (Vo, P): features (Vo, Cin) on its output sites
    back onto its n_out input rows, out[i] = sum over pairs[o, p] == i of
    weights[p]^T features[o], plus the bias on the rows any pair touches."""
    Cout = weights.shape[-1]
    contrib = torch.einsum("vc,pcd->vpd", features, weights)
    mask = (pairs >= 0).reshape(-1)
    rows = pairs.reshape(-1)[mask]
    out = torch.zeros((n_out, Cout), dtype=features.dtype,
                      device=features.device)
    out.index_add_(0, rows, contrib.reshape(-1, Cout)[mask])
    if bias is not None:
        touched = torch.zeros((n_out,), dtype=torch.bool,
                              device=features.device)
        touched[rows] = True
        out = out + bias * touched[:, None]
    return out


def sparse_maxpool3d(features: torch.Tensor, coords: torch.Tensor,
                     valid: torch.Tensor, kernel_size: int,
                     stride: Optional[int] = None, padding: int = 0,
                     capacity: Optional[int] = None,
                     spatial_shape: Optional[Sequence[int]] = None):
    """Sparse max pooling (spconv SparseMaxPool3d): the strided conv's
    output sites, each the max over its present taps only. Returns
    (out_features, out_coords, out_valid); capacity defaults to
    V * ceil(k / stride)^3."""
    stride = stride or kernel_size
    capacity = capacity or coords.shape[0] * (-(-kernel_size // stride)) ** 3
    out_coords, out_valid, pairs = build_strided_output(
        coords, valid, kernel_size, stride, padding, capacity, spatial_shape)
    mask = pairs >= 0
    neg = torch.finfo(features.dtype).min
    gathered = torch.where(mask[..., None],
                           features[torch.clamp(pairs, min=0)],
                           torch.tensor(neg, dtype=features.dtype,
                                        device=features.device))
    out = torch.amax(gathered, dim=1)
    return (torch.where(out_valid[:, None], out, torch.zeros_like(out)),
            out_coords, out_valid)


def to_dense(features: torch.Tensor, coords: torch.Tensor,
             valid: torch.Tensor, spatial_shape: Sequence[int]
             ) -> torch.Tensor:
    """Scatter-add a voxel set into a dense channel-last (D, H, W, C) grid
    (spconv ToDense, NCDHW there)."""
    D, H, W = spatial_shape
    C = features.shape[-1]
    c = coords.long()
    lin = (c[:, 0] * H + c[:, 1]) * W + c[:, 2]
    keep = valid.bool() & (lin >= 0) & (lin < D * H * W)
    dense = torch.zeros((D * H * W, C), dtype=features.dtype,
                        device=features.device)
    dense.index_add_(0, lin[keep], features[keep])
    return dense.reshape(D, H, W, C)
