"""Rotated-box geometry (port of ops/boxes.py): the membership test, box
corners, the box frame, rotated BEV and 3D overlaps and IoUs, and greedy
BEV NMS.

Boxes follow the LiDAR convention (x, y, z_bottom, dx, dy, dz, yaw); the
crop and NMS callers pass gravity-centred boxes where they say so.
"""
from __future__ import annotations

import numpy as np
import torch


def points_in_rboxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points (N, 3), boxes (M, 7) -> (N, M) bool membership mask.

    Points are rotated into each box frame and compared with the half
    extents; z is tested against [z_bottom, z_bottom + dz]."""
    rel = points[:, None, :2] - boxes[None, :, :2]                # (N,M,2)
    c, s = torch.cos(-boxes[:, 6]), torch.sin(-boxes[:, 6])
    local_x = rel[..., 0] * c[None] - rel[..., 1] * s[None]
    local_y = rel[..., 0] * s[None] + rel[..., 1] * c[None]
    in_x = torch.abs(local_x) <= boxes[None, :, 3] * 0.5
    in_y = torch.abs(local_y) <= boxes[None, :, 4] * 0.5
    z = points[:, None, 2]
    in_z = (z >= boxes[None, :, 2]) & (z <= boxes[None, :, 2] + boxes[None, :, 5])
    return in_x & in_y & in_z


def rotation_2d(yaw: torch.Tensor) -> torch.Tensor:
    """(...,) yaw -> (..., 2, 2) counter-clockwise rotation matrices."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       dim=-2)


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes -> (..., 4, 2) BEV corners, counter-clockwise."""
    tmpl = torch.tensor([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]],
                        dtype=boxes.dtype, device=boxes.device)
    local = tmpl * boxes[..., None, 3:5]
    world = torch.einsum("...ij,...kj->...ki", rotation_2d(boxes[..., 6]),
                         local)
    return world + boxes[..., None, :2]


def box_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes -> (..., 8, 3) corners, the bottom four then the top
    four."""
    bev = box_corners_bev(boxes)
    z0 = boxes[..., None, 2:3].expand(bev.shape[:-1] + (1,))
    z1 = (boxes[..., 2:3] + boxes[..., 5:6])[..., None, :].expand(
        bev.shape[:-1] + (1,))
    return torch.cat([torch.cat([bev, z0], -1), torch.cat([bev, z1], -1)],
                     dim=-2)


def points_to_box_frame(points: torch.Tensor, box: torch.Tensor
                        ) -> torch.Tensor:
    """points (N, 3) -> (N, 3) in the frame of one box (7,): rotated by
    -yaw about the box centre, z relative to the gravity centre."""
    rel = points[:, :2] - box[None, :2]
    c, s = torch.cos(-box[6]), torch.sin(-box[6])
    x = rel[:, 0] * c - rel[:, 1] * s
    y = rel[:, 0] * s + rel[:, 1] * c
    z = points[:, 2] - (box[2] + box[5] * 0.5)
    return torch.stack([x, y, z], dim=-1)


# vertex buffer of the clipped polygon: two quads intersect in at most 8
# vertices; the buffer and its wrap-around indexing are the JAX package's
MAXV = 16


def _polygon_clip(subject: torch.Tensor, clip: torch.Tensor):
    """Sutherland-Hodgman clipping of convex quads `subject` (P, 4, 2) by
    convex quads `clip` (P, 4, 2), all P pairs at once. Returns (verts
    (P, MAXV, 2), count (P,)).

    Per clip edge, every slot j of the vertex buffer is visited at once (a
    slot counts while j < count; its predecessor is j - 1, or count - 1 for
    j = 0), emitting the edge crossing from its predecessor and then the
    vertex itself where they apply. Emits land at their running position
    modulo MAXV, the last write of a slot winning, exactly as the JAX
    package's sequential walk writes them; a few dozen batched operations a
    clip in place of a walk of the slots."""
    P = subject.shape[0]
    dev, dtype = subject.device, subject.dtype
    verts = torch.cat([subject, subject.new_zeros((P, MAXV - 4, 2))], dim=1)
    n = torch.full((P,), 4, dtype=torch.int64, device=dev)
    j = torch.arange(MAXV, device=dev)
    dump = torch.full((), MAXV, dtype=torch.int64, device=dev)
    for i in range(4):
        a = clip[:, None, i]                                 # (P, 1, 2)
        b = clip[:, None, (i + 1) % 4]
        edge = b - a
        dc = a - b
        n1 = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]  # (P, 1)
        # the small negative tolerance absorbs float32 flicker of vertices
        # on the edge
        inside = (edge[..., 0] * (verts[..., 1] - a[..., 1])
                  - edge[..., 1] * (verts[..., 0] - a[..., 0])) >= -1e-5
        prv_idx = torch.where(j == 0, torch.clamp(n - 1, min=0)[:, None],
                              (j - 1)[None, :]) % MAXV        # (P, MAXV)
        prv = torch.gather(verts, 1, prv_idx[..., None].expand(P, MAXV, 2))
        prv_in = torch.gather(inside, 1, prv_idx)
        # crossing of the segment prv -> cur with the clip edge's line
        dp = prv - verts
        n2 = prv[..., 0] * verts[..., 1] - prv[..., 1] * verts[..., 0]
        denom = dc[..., 0] * dp[..., 1] - dc[..., 1] * dp[..., 0]
        denom = torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
        cross = (n1[..., None] * dp - n2[..., None] * dc) / denom[..., None]
        valid = j[None, :] < n[:, None]
        e_cross = valid & (inside != prv_in)
        e_cur = valid & inside
        cnt = e_cross.long() + e_cur.long()
        pos_cross = torch.cumsum(cnt, dim=1) - cnt           # exclusive
        pos_cur = pos_cross + e_cross.long()
        m = cnt.sum(dim=1)
        last = (m - MAXV)[:, None]        # earlier positions are overwritten
        out = torch.zeros((P, MAXV + 1, 2), dtype=dtype, device=dev)
        for emit, pos, val in ((e_cross, pos_cross, cross),
                               (e_cur, pos_cur, verts)):
            slot = torch.where(emit & (pos >= last), pos % MAXV, dump)
            out.scatter_(1, slot[..., None].expand(P, MAXV, 2), val)
        verts, n = out[:, :MAXV], m
    return verts, n


def _polygon_area(verts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace areas of (P, MAXV, 2) vertex buffers with (P,) counts."""
    idx = torch.arange(verts.shape[1], device=verts.device)
    nxt = (idx[None, :] + 1) % torch.clamp(n, min=1)[:, None]
    x, y = verts[..., 0], verts[..., 1]
    xn, yn = torch.gather(x, 1, nxt), torch.gather(y, 1, nxt)
    cross = torch.where(idx[None, :] < n[:, None], x * yn - xn * y,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    return 0.5 * cross.sum(dim=1).abs()


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                      ) -> torch.Tensor:
    """Exact rotated BEV overlap areas, (N, 7) x (M, 7) -> (N, M): every
    pair's corner quads clipped in one batched pass.

    Each pair is clipped about box a's centre: corners about their own
    centres, b's placed at the difference of the centres, which float32
    gives exactly for boxes near enough to overlap. (The JAX package clips
    in lidar coordinates, where the edge lines' cross products cancel: at
    50 m from the sensor its IoU moves by 5e-5 with the rounding of the
    corners.)"""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    if N == 0 or M == 0:
        return boxes_a.new_zeros((N, M))

    def local_corners(boxes):
        return box_corners_bev(torch.cat([torch.zeros_like(boxes[:, :2]),
                                          boxes[:, 2:]], dim=1))

    ca = local_corners(boxes_a)                                  # (N,4,2)
    cb = local_corners(boxes_b)                                  # (M,4,2)
    rel = boxes_b[None, :, :2] - boxes_a[:, None, :2]            # (N,M,2)
    sub = ca[:, None].expand(N, M, 4, 2).reshape(N * M, 4, 2)
    clp = (cb[None] + rel[:, :, None, :]).reshape(N * M, 4, 2)
    verts, n = _polygon_clip(sub, clp)
    return _polygon_area(verts, n).reshape(N, M)


def _clamped_bev_overlap(boxes_a, boxes_b):
    """BEV overlap, no more than the smaller footprint of the pair."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    return torch.minimum(inter, torch.minimum(area_a[:, None],
                                              area_b[None, :])), area_a, area_b


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                  ) -> torch.Tensor:
    """Rotated BEV IoU, (N, 7) x (M, 7) -> (N, M) in [0, 1]."""
    inter, area_a, area_b = _clamped_bev_overlap(boxes_a, boxes_b)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.clamp(inter / torch.clamp(union, min=1e-8), 0.0, 1.0)


def boxes_iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                 ) -> torch.Tensor:
    """Rotated 3D IoU, (N, 7) x (M, 7) -> (N, M): BEV overlap times the
    overlap of the z ranges [z, z + dz]."""
    inter_bev, _, _ = _clamped_bev_overlap(boxes_a, boxes_b)
    za0, za1 = boxes_a[:, 2], boxes_a[:, 2] + boxes_a[:, 5]
    zb0, zb1 = boxes_b[:, 2], boxes_b[:, 2] + boxes_b[:, 5]
    zo = torch.clamp(torch.minimum(za1[:, None], zb1[None, :])
                     - torch.maximum(za0[:, None], zb0[None, :]), min=0.0)
    inter = inter_bev * zo
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return inter / torch.clamp(vol_a[:, None] + vol_b[None, :] - inter,
                               min=1e-8)


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
            max_out: int) -> torch.Tensor:
    """Greedy rotated BEV NMS -> (max_out,) int64 keep indices in order of
    falling score, -1 past the last one kept.

    Candidates go in a stable sort of -scores (ties keep index order); a
    kept box suppresses every box whose IoU with it is > thresh. The IoU
    matrix is computed on the boxes' device in one pass and `iou > thresh`
    fetched once; the greedy scan runs on the host, so the result is a CPU
    tensor."""
    n = boxes.shape[0]
    keep = np.full((max_out,), -1, np.int64)
    if n == 0 or max_out <= 0:
        return torch.from_numpy(keep)
    sup = boxes_iou_bev(boxes, boxes) > thresh
    order = torch.sort(-scores, stable=True).indices.cpu().numpy()
    sup = sup.cpu().numpy()
    alive = np.ones((n,), bool)
    k = 0
    for cand in order:
        if k >= max_out:
            break
        if alive[cand]:
            keep[k] = cand
            k += 1
            alive &= ~sup[cand]
    return torch.from_numpy(keep)
