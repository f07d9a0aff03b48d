"""Track x detection pair scoring against a device-resident or a host track
cache.

Port of point_cloud_reid_tpu/inference/pair_scoring.py (FeatureCache,
DeviceTrackCache, _round_up, PairScorer's embed / cost_matrix / frame
functions / score_frame, point and image branch). A device-cache tracking
frame is one call:

  scatter last frame's detection features into their track slots ->
  gather this frame's track rows by slot -> crop + embed the detections ->
  score the dense grid (make_cached_frame_fn) or a gated pair list
  (make_cached_pair_frame_fn).

With image_mode the crops are camera crops of the frame's images
(tracking/image_crops.py), the embedding is the ViT's tokens through the
per-token downsample, and there is no xyz anywhere
(make_cached_image_frame_fn, make_cached_image_pair_frame_fn).

Only the logits leave the device. The host-cache frame (FeatureCache,
make_frame_fn, score_frame) is the other deployment: track features live in
host memory, go up with every frame and the detections' features come back
down, on purpose (a caller that crops its own inputs, or keeps features
between processes). The kernels run whenever the tensors are on CUDA
(kernels/). The frame functions take their shapes from their
arguments, which TrackingManager pads to static buckets; unlike JAX's they
need no bucket sizes of their own until frames are captured as CUDA graphs.

With a mesh (parallel.make_mesh) every frame is scored shard by shard, as
JAX's scorer under a mesh: the detections' crops are embedded in
contiguous shards through the SA kernel (point branch), the grid's
detections or the pair list go in contiguous shards through the match
kernels (kernels/match_grid.sharded_*), each shard on its mesh entry's
device; the results are concatenated on the first entry's device. A
TrackingManager scores sharded when its scorer has a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.match_grid import (check_image_head, fused_head_ok,
                                  grid_logits, image_grid_logits,
                                  image_pair_logits, pair_logits,
                                  run_sharded, sharded_grid_logits,
                                  sharded_image_grid_logits,
                                  sharded_image_pair_logits,
                                  sharded_pair_logits)
from ..utils.cache import model_on


def host(x):
    """A fetched copy in host memory: numpy, or a CPU tensor for bf16, which
    numpy has no type for (the bits are kept: never through float32)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def host_logits(x: torch.Tensor) -> np.ndarray:
    """float32 or bf16 logits as float64 numpy (an exact widening)."""
    return x.detach().cpu().to(torch.float64).numpy()


class FeatureCache:
    """Per-track embedding cache in host memory: rows keyed by track id,
    written when a track is born or matched, stacked per frame. Rows are
    numpy, or CPU tensors for a bf16 model's features (`host`)."""

    def __init__(self):
        self._h: Dict[int, np.ndarray] = {}
        self._xyz: Dict[int, np.ndarray] = {}

    def update(self, track_ids, h, xyz=None) -> None:
        """h (n, N, C) and xyz (n, N, 3) or None, numpy or tensors (fetched
        once, not per row)."""
        h, xyz = host(h), host(xyz)
        for i, tid in enumerate(track_ids):
            self._h[int(tid)] = h[i]
            if xyz is not None:
                self._xyz[int(tid)] = xyz[i]

    def gather(self, track_ids):
        """(h (T, N, C), xyz (T, N, 3) or None when no xyz was stored)."""
        rows = [self._h[int(t)] for t in track_ids]
        h = (torch.stack(rows) if isinstance(rows[0], torch.Tensor)
             else np.stack(rows))
        xyz = (np.stack([self._xyz[int(t)] for t in track_ids])
               if self._xyz else None)
        return h, xyz

    def drop(self, track_ids) -> None:
        for tid in track_ids:
            self._h.pop(int(tid), None)
            self._xyz.pop(int(tid), None)

    def __len__(self):
        return len(self._h)


class DeviceTrackCache:
    """Fixed-capacity (cap + 1, N, C) track-feature store on the device.

    Slot bookkeeping (track id -> slot, free list, pending det -> slot
    updates decided by host association) is host state. Slot `capacity` is
    a scratch row: padded gathers read it, masked-out scatters write it.
    """

    # a real denser-than-expected scene needs a doubling or two; 16x the
    # constructed capacity means slots leak (tracks never dropped)
    _MAX_GROWTH = 16

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._initial_capacity = capacity
        self._slots: Dict[int, int] = {}
        self._free = list(range(capacity))
        self.h_buf: Optional[torch.Tensor] = None      # (cap+1, N, C)
        self.xyz_buf: Optional[torch.Tensor] = None    # (cap+1, N, 3)
        self._pending: list = []

    def ensure(self, n: int, c: int, dtype, device,
               with_xyz: bool = True) -> None:
        """Allocate the buffers at first use; the image branch keeps no
        xyz (with_xyz=False)."""
        if self.h_buf is None:
            self.h_buf = torch.zeros((self.capacity + 1, n, c), dtype=dtype,
                                     device=device)
            if with_xyz:
                self.xyz_buf = torch.zeros((self.capacity + 1, n, 3),
                                           dtype=torch.float32, device=device)

    def slot(self, track_id: int) -> int:
        return self._slots[int(track_id)]

    def grow(self) -> None:
        """Double the capacity: live slots keep their rows, the scratch row
        moves to the new last index, the new rows join the free list."""
        old = self.capacity
        if old * 2 > self._initial_capacity * self._MAX_GROWTH:
            raise RuntimeError(
                f"DeviceTrackCache grew past {self._MAX_GROWTH}x its "
                f"constructed capacity ({self._initial_capacity} -> "
                f"{old * 2}): {len(self._slots)} slots are live. This is "
                "almost certainly a slot leak (drop() dead tracks); construct "
                "with a larger capacity if the scene truly is that dense.")
        self.capacity = old * 2
        self._free.extend(range(old, self.capacity))

        def widen(buf):
            if buf is None:
                return None
            pad = torch.zeros((old + 1,) + tuple(buf.shape[1:]),
                              dtype=buf.dtype, device=buf.device)
            return torch.cat([buf[:old], pad], dim=0)
        self.h_buf = widen(self.h_buf)
        self.xyz_buf = widen(self.xyz_buf)

    def assign(self, track_id: int) -> int:
        if not self._free:
            self.grow()
        s = self._free.pop()
        self._slots[int(track_id)] = s
        return s

    def drop(self, track_ids) -> None:
        for tid in track_ids:
            s = self._slots.pop(int(tid), None)
            if s is not None:
                self._free.append(s)

    def queue_update(self, det_idx: int, slot: int) -> None:
        self._pending.append((det_idx, slot))

    def take_updates(self, d_prev_pad: int):
        """Pending (src det row, dst slot) pairs as padded index arrays;
        unused entries read det row 0 and write the scratch slot."""
        src = np.zeros((d_prev_pad,), np.int64)
        dst = np.full((d_prev_pad,), self.capacity, np.int64)
        for i, (di, s) in enumerate(self._pending[:d_prev_pad]):
            src[i] = di
            dst[i] = s
        self._pending = []
        return src, dst

    def __len__(self):
        return len(self._slots)


def _round_up(n: int, sizes=(8, 16, 32, 64, 128, 256, 512)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return int(2 ** np.ceil(np.log2(max(n, 1))))


class PairScorer:
    """N x M match scoring on top of a ReIDNet or, with image_mode, of an
    ImageReIDNet.

    Args:
        model: an eval-mode ReIDNet or ImageReIDNet (models.build_model).
            The frame's tensors live on its device: CUDA runs the kernels,
            the CPU their plain versions. A ReIDNet whose match head the
            fused kernels compute (kernels.match_grid.fused_head_ok: the
            xcorr_eff heads of the point-transformer, PointNet, DGCNN and
            VN-DGCNN backbones) is scored through them; any other (the
            concat, xcorr-baseline and xcorr heads, the other combines and
            pools, LoFTR stages, another attention primitive,
            ReIDNetCosine) by its own match_logits_grid /
            match_logits_pairs, as JAX's scorer does.
        image_mode: score camera crops; no xyz anywhere. The model must be
            an ImageReIDNet (kernels.match_grid.check_image_head); a head
            the image kernel computes (fused_head_ok with image_mode) runs
            through it, any other through ImageReIDNet.match_logits_grid /
            match_logits over the gathered pairs, as JAX's scorer does.
        mesh: a parallel.make_mesh grid: score every frame in one shard a
            mesh entry (the module docstring), on any count of detections
            or pairs. A head that fused_head_ok refuses is scored by the
            model's own path over the same shards.
    """

    def __init__(self, model, image_mode: bool = False, mesh=None):
        self.model = model
        self.image_mode = image_mode
        self.mesh = mesh
        if image_mode:
            check_image_head(model)
        # whether frames run the fused match kernels (grid_logits and
        # pair_logits decide with the same gate)
        self.fused = fused_head_ok(model, image_mode)
        self.device = next(model.parameters()).device
        # the last scored frame's (padded) inputs and output: h_t, xyz_t,
        # h_d, xyz_d (xyz None in image mode), logits, and pairs ((pair_t,
        # pair_d) or None for a dense grid), so a caller can check a frame
        # against plain scoring
        self.last_frame: Optional[dict] = None

    @torch.no_grad()
    def embed(self, crops: torch.Tensor):
        """(B, N, 3) crops -> (xyz (B, N, 3), h (B, N, C)); image mode:
        (B, 3, H, W) crops -> (None, h (B, S, C)), the ViT's tokens through
        the per-token downsample. With a mesh the point crops are embedded
        in contiguous shards, one on each entry's device."""
        if self.image_mode:
            return None, self.model.downsample_tokens(self.model.embed(crops))
        if self.mesh is None:
            return self.model.embed(crops)
        first = self.mesh.flat[0]

        def shard(dev, lo, hi):
            xyz, h = model_on(self.model, dev).embed(crops[lo:hi].to(dev))
            return xyz.to(first), h.to(first)
        parts = run_sharded(self.mesh, crops.shape[0], shard)
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    # ---- scoring, whole or sharded ----------------------------------------

    def _grid(self, h_t, xyz_t, h_d, xyz_d):
        if self.mesh is None:
            return grid_logits(self.model, h_t, xyz_t, h_d, xyz_d)
        return sharded_grid_logits(self.model, h_t, xyz_t, h_d, xyz_d,
                                   self.mesh)

    def _pairs(self, h_t, xyz_t, h_d, xyz_d, t_idx, d_idx):
        if self.mesh is None:
            return pair_logits(self.model, h_t, xyz_t, h_d, xyz_d, t_idx,
                               d_idx)
        return sharded_pair_logits(self.model, h_t, xyz_t, h_d, xyz_d,
                                   t_idx, d_idx, self.mesh)

    def _image_grid(self, h_t, h_d):
        if self.mesh is None:
            return image_grid_logits(self.model, h_t, h_d)
        return sharded_image_grid_logits(self.model, h_t, h_d, self.mesh)

    def _image_pairs(self, h_t, h_d, t_idx, d_idx):
        if self.mesh is None:
            return image_pair_logits(self.model, h_t, h_d, t_idx, d_idx)
        return sharded_image_pair_logits(self.model, h_t, h_d, t_idx, d_idx,
                                         self.mesh)

    @torch.no_grad()
    def cost_matrix(self, h_tracks, xyz_tracks, h_dets, xyz_dets,
                    track_classes: Optional[np.ndarray] = None,
                    det_classes: Optional[np.ndarray] = None
                    ) -> torch.Tensor:
        """(n_tracks, n_dets) logits; class-mismatched pairs get -inf.
        Both sides are zero-padded to _round_up buckets first, and the
        padded grid is kept in last_frame. In image mode xyz_tracks and
        xyz_dets are None."""
        nt, nd = h_tracks.shape[0], h_dets.shape[0]
        nt_p, nd_p = _round_up(nt), _round_up(nd)

        def pad0(x, n):
            if x is None or x.shape[0] == n:
                return x
            return torch.cat([x, x.new_zeros((n - x.shape[0],)
                                             + tuple(x.shape[1:]))])

        h_t, h_d = pad0(h_tracks, nt_p), pad0(h_dets, nd_p)
        x_t, x_d = pad0(xyz_tracks, nt_p), pad0(xyz_dets, nd_p)
        if self.image_mode:
            grid = self._image_grid(h_t, h_d)
        else:
            grid = self._grid(h_t, x_t, h_d, x_d)
        self.last_frame = dict(h_t=h_t, xyz_t=x_t, h_d=h_d, xyz_d=x_d,
                               logits=grid, pairs=None)
        mat = grid[:nt, :nd]
        if track_classes is not None and det_classes is not None:
            ok = torch.as_tensor(np.asarray(track_classes)[:, None]
                                 == np.asarray(det_classes)[None, :],
                                 device=mat.device)
            mat = torch.where(ok, mat, torch.full_like(mat, -float("inf")))
        return mat

    def make_frame_fn(self, n_tracks: int, n_dets: int,
                      crop_points: Optional[int] = None):
        """Host-cache frame for one (track, det) bucket: [crop +] embed the
        detections and score the full n_tracks x n_dets grid in one call.

        Returns fn(h_t (n_tracks, N, C), xyz_t (n_tracks, N, 3) or None,
        dets) -> (logits (n_tracks, n_dets), h_dets, xyz_dets). With
        crop_points (point branch only) `dets` is (seed, sweep (n_pts, 3),
        boxes (n_dets, 7)) and the crops are cut on the device from a
        generator seeded with `seed`; otherwise `dets` is the crop batch.
        Every tensor lives on the model's device; a shape off the bucket
        raises."""
        if self.image_mode and crop_points:
            raise ValueError("on-device box crops are a point-branch path")

        @torch.no_grad()
        def frame(h_t, xyz_t, dets):
            if crop_points is not None:
                # tracking/ imports this module: import its crops at call time
                from ..tracking.crops import extract_box_crops
                seed, pts, boxes = dets
                gen = torch.Generator(device=pts.device).manual_seed(
                    int(seed))
                det_crops, _ = extract_box_crops(gen, pts, boxes,
                                                 crop_points)
            else:
                det_crops = dets
            if h_t.shape[0] != n_tracks or det_crops.shape[0] != n_dets:
                raise ValueError(
                    f"frame bucket ({n_tracks}, {n_dets}) got "
                    f"({h_t.shape[0]}, {det_crops.shape[0]})")
            xyz_d, h_d = self.embed(det_crops)
            if self.image_mode:
                logits = self._image_grid(h_t, h_d)
            else:
                logits = self._grid(h_t, xyz_t, h_d, xyz_d)
            self.last_frame = dict(h_t=h_t, xyz_t=xyz_t, h_d=h_d,
                                   xyz_d=xyz_d, logits=logits, pairs=None)
            return logits, h_d, xyz_d
        return frame

    def score_frame(self, cache: FeatureCache, track_ids, det_crops,
                    track_classes=None, det_classes=None):
        """One host-cache frame: embed the detections' crops, score them
        against the cached track features. Returns (logits (n_tracks,
        n_dets), h_dets, xyz_dets); with no tracks (a scene's start) the
        matrix is (0, n_dets)."""
        xyz_d, h_d = self.embed(det_crops)
        if len(track_ids) == 0:
            return h_d.new_zeros((0, h_d.shape[0])), h_d, xyz_d
        h_t, xyz_t = cache.gather(track_ids)
        dev = self.device
        mat = self.cost_matrix(
            torch.as_tensor(h_t).to(dev),
            None if xyz_t is None else torch.from_numpy(xyz_t).to(dev),
            h_d, xyz_d, track_classes, det_classes)
        return mat, h_d, xyz_d

    def _frame_inputs(self, h_buf, xyz_buf, prev_h, prev_xyz, upd_src,
                      upd_dst, slot_idx, seed, pts, boxes, crop_points):
        """Shared scatter / gather / crop / embed of both frame functions.
        The cache buffers are updated in place."""
        # tracking/ imports this module: import its crops at call time
        from ..tracking.crops import extract_box_crops
        h_buf[upd_dst] = prev_h[upd_src]
        xyz_buf[upd_dst] = prev_xyz[upd_src]
        h_t = h_buf[slot_idx]
        xyz_t = xyz_buf[slot_idx]
        gen = torch.Generator(device=pts.device).manual_seed(int(seed))
        det_crops, _ = extract_box_crops(gen, pts, boxes, crop_points)
        xyz_d, h_d = self.embed(det_crops)
        return h_t, xyz_t, h_d, xyz_d

    def _record(self, inputs, logits, pairs):
        self.last_frame = dict(zip(("h_t", "xyz_t", "h_d", "xyz_d"), inputs),
                               logits=logits, pairs=pairs)

    def make_cached_frame_fn(self, crop_points: int):
        """Dense frame against a DeviceTrackCache.

        Returns fn(h_buf, xyz_buf, prev_h, prev_xyz, upd_src (d_prev_pad,),
        upd_dst, slot_idx (t_pad,), seed, pts, boxes (d_pad, 7)) ->
        (h_buf, xyz_buf, logits (t_pad, d_pad), h_dets, xyz_dets)."""

        @torch.no_grad()
        def frame(h_buf, xyz_buf, prev_h, prev_xyz, upd_src, upd_dst,
                  slot_idx, seed, pts, boxes):
            inputs = self._frame_inputs(
                h_buf, xyz_buf, prev_h, prev_xyz, upd_src, upd_dst,
                slot_idx, seed, pts, boxes, crop_points)
            logits = self._grid(*inputs)
            self._record(inputs, logits, None)
            return h_buf, xyz_buf, logits, inputs[2], inputs[3]
        return frame

    def make_cached_pair_frame_fn(self, crop_points: int):
        """Gated sparse frame: the same plumbing, but only an explicit pair
        list is scored. Returns fn(h_buf, xyz_buf, prev_h, prev_xyz,
        upd_src, upd_dst, slot_idx, pair_t (p_pad,), pair_d (p_pad,), seed,
        pts, boxes) -> (h_buf, xyz_buf, logits (p_pad,), h_dets,
        xyz_dets). Padded pairs point at (0, 0); the caller drops them."""

        @torch.no_grad()
        def frame(h_buf, xyz_buf, prev_h, prev_xyz, upd_src, upd_dst,
                  slot_idx, pair_t, pair_d, seed, pts, boxes):
            inputs = self._frame_inputs(
                h_buf, xyz_buf, prev_h, prev_xyz, upd_src, upd_dst,
                slot_idx, seed, pts, boxes, crop_points)
            logits = self._pairs(*inputs, pair_t, pair_d)
            self._record(inputs, logits, (pair_t, pair_d))
            return h_buf, xyz_buf, logits, inputs[2], inputs[3]
        return frame

    # ---- image branch ---------------------------------------------------------

    def _device_crops(self, images, l2cams, intrins, boxes, image_size,
                      output_size):
        """Camera crops of a frame's boxes on the images' device, in the
        model's compute dtype. uint8 frames are taken as they are: the crops
        gather uint8 rows and convert only the picked pixels."""
        # tracking/ imports this module: import its crops at call time
        from ..tracking.image_crops import crops_per_frame
        crops, _ = crops_per_frame(images, l2cams, intrins, boxes,
                                   image_size=image_size,
                                   output_size=output_size,
                                   dtype=self.model.dtype)
        return crops

    def _image_frame_inputs(self, h_buf, prev_h, upd_src, upd_dst, slot_idx,
                            images, l2cams, intrins, boxes, image_size,
                            output_size):
        """Scatter / gather / camera crops / embed of both image frame
        functions. The cache buffer is updated in place."""
        h_buf[upd_dst] = prev_h[upd_src]
        h_t = h_buf[slot_idx]
        crops = self._device_crops(images, l2cams, intrins, boxes,
                                   image_size, output_size)
        _, h_d = self.embed(crops)
        return h_t, h_d

    def _record_image(self, h_t, h_d, logits, pairs):
        self.last_frame = dict(h_t=h_t, xyz_t=None, h_d=h_d, xyz_d=None,
                               logits=logits, pairs=pairs)

    def make_cached_image_frame_fn(self, image_size, output_size):
        """Dense image frame against a DeviceTrackCache: scatter last
        frame's detection tokens into their track slots, gather this frame's
        track rows, project the boxes into the cameras, crop, embed, score
        the grid.

        Returns fn(h_buf, prev_h, upd_src (d_prev_pad,), upd_dst, slot_idx
        (t_pad,), images (ncam, 3, H, W) float32 or uint8, lidar2cams
        (ncam, 4, 4), intrinsics (ncam, 3, 3), boxes (d_pad, 7)) ->
        (h_buf, logits (t_pad, d_pad), h_dets). image_size is (W, H)."""
        if not self.image_mode:
            raise RuntimeError("image frame functions need image_mode=True")
        sizes = tuple(image_size), tuple(output_size)

        @torch.no_grad()
        def frame(h_buf, prev_h, upd_src, upd_dst, slot_idx, images, l2cams,
                  intrins, boxes):
            h_t, h_d = self._image_frame_inputs(
                h_buf, prev_h, upd_src, upd_dst, slot_idx, images, l2cams,
                intrins, boxes, *sizes)
            logits = self._image_grid(h_t, h_d)
            self._record_image(h_t, h_d, logits, None)
            return h_buf, logits, h_d
        return frame

    def make_cached_image_pair_frame_fn(self, image_size, output_size):
        """Gated sparse image frame: the same plumbing, but only an explicit
        pair list is scored. Returns fn(h_buf, prev_h, upd_src, upd_dst,
        slot_idx, pair_t (p_pad,), pair_d (p_pad,), images, lidar2cams,
        intrinsics, boxes) -> (h_buf, logits (p_pad,), h_dets). Padded pairs
        point at (0, 0); the caller drops them."""
        if not self.image_mode:
            raise RuntimeError("image frame functions need image_mode=True")
        sizes = tuple(image_size), tuple(output_size)

        @torch.no_grad()
        def frame(h_buf, prev_h, upd_src, upd_dst, slot_idx, pair_t, pair_d,
                  images, l2cams, intrins, boxes):
            h_t, h_d = self._image_frame_inputs(
                h_buf, prev_h, upd_src, upd_dst, slot_idx, images, l2cams,
                intrins, boxes, *sizes)
            logits = self._image_pairs(h_t, h_d, pair_t, pair_d)
            self._record_image(h_t, h_d, logits, (pair_t, pair_d))
            return h_buf, logits, h_d
        return frame
