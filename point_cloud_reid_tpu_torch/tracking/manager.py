"""Per-frame tracking orchestration, point and image branch, with the
device or the host feature cache.

Port of point_cloud_reid_tpu/tracking/manager.py::TrackingManager. Per frame:
optional BEV NMS of the detections, pad the sweep and the boxes to static
buckets, gate track x detection pairs by class and BEV distance on the
host, score, associate and update track lifecycles on the host, and feed an
optional tracking-eval recorder. Scoring runs one of two ways:

  device cache (the default without a crop_fn): ONE frame function
    scatters last frame's features, gathers track rows, crops + embeds the
    detections and scores the dense grid or the gated pair list; only the
    logits come back.
  host cache (device_cache=False, or a crop_fn): track features live in a
    host FeatureCache. Point frames without a crop_fn run crops + embed +
    grid in one call (PairScorer.make_frame_fn); otherwise the detections
    are cropped (crop_fn, or camera crops in image mode) and embedded, and
    scored by PairScorer.cost_matrix. The detections' features come back
    to the host every frame.

Over a PairScorer in image mode the frame is (images, lidar2cams,
intrinsics) instead of a lidar sweep, the crops are camera crops, and no
xyz is kept.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..inference.pair_scoring import (DeviceTrackCache, FeatureCache,
                                      PairScorer, _round_up, host,
                                      host_logits)
from ..ops.boxes import nms_bev
from .association import associate, center_distance_gate
from .crops import extract_box_crops
from .track import Track, TrackStore

# sweep pad-bucket ladder (points per lidar frame); the crop stage's cost
# is linear in the padded row count
SWEEP_SIZES = (2048, 8192, 32768, 65536, 131072, 196608, 262144,
               393216, 524288)


class TrackingManager:
    """ReID-driven 3D MOT.

    Args:
        scorer: inference.PairScorer over a ReIDNet, or over an
            ImageReIDNet with image_mode=True.
        subsample_number: points per crop (128 in released configs); not
            read in image mode.
        match_threshold: max association cost; cost = 1 - sigmoid(logit).
        max_distance: BEV centre gate radius.
        method: 'greedy' | 'hungarian'.
        max_age / min_hits: track lifecycle.
        nms_threshold: optional BEV-IoU NMS of the incoming detections (a
            detection is dropped when its IoU with a higher-scored kept one
            is > nms_threshold); applied when a frame has 2+ detections.
        seed: offsets both crop seed streams.
        crop_fn: crop_fn(frame, boxes_padded (M, 7) numpy) -> (M, ...)
            crop tensor, in place of the lidar extractor; step()'s `points`
            is handed to it as it is. The image branch can pass a closure
            over tracking.image_crops.crops_per_frame.
        eval_recorder: optional evaluation.TrackingEvalAccumulator, fed
            every frame whose step() gets det_gt_ids, at every prune and at
            end_scene.
        device_cache: keep track features on the device (default: when
            there is no crop_fn); False keeps them in a host FeatureCache.
        cache_capacity: initial DeviceTrackCache slots.
        sparse_scoring: 'auto' scores only gate survivors once the padded
            grid exceeds _SPARSE_MIN_GRID pairs; 'always' / 'never' force it
            (device cache only).

    Crops are drawn from two seed streams, each a named integer: the frame
    functions (device cache, and the host cache's one-call point frame)
    seed with `_seed`, which counts up from seed * 1_000_003 every frame
    they run; the other host-cache embeds (a scene's first point frame)
    with `_rng_seed`, which counts up from seed * 1_000_003 + _RNG_OFFSET.
    """

    # padded-grid size past which 'auto' sparse scoring kicks in; the >25 %
    # gate-pass fallback in step() guards crowded scenes at any size
    _SPARSE_MIN_GRID = 4096
    # start of the second crop seed stream past the first's
    _RNG_OFFSET = 1 << 30

    def __init__(self, scorer: PairScorer, subsample_number: int = 128,
                 match_threshold: float = 0.7, max_distance: float = 2.0,
                 method: str = "greedy", max_age: int = 3, min_hits: int = 1,
                 nms_threshold: Optional[float] = None, seed: int = 0,
                 crop_fn=None, eval_recorder=None,
                 device_cache: Optional[bool] = None,
                 cache_capacity: int = 512, sparse_scoring: str = "auto"):
        if sparse_scoring not in ("auto", "always", "never"):
            raise ValueError(f"sparse_scoring={sparse_scoring!r}")
        self.scorer = scorer
        self.device = scorer.device
        self.crop_fn = crop_fn
        self.eval_recorder = eval_recorder
        self.subsample_number = subsample_number
        self.match_threshold = match_threshold
        self.max_distance = max_distance
        self.method = method
        self.nms_threshold = nms_threshold
        self.sparse_scoring = sparse_scoring
        self.store = TrackStore(max_age=max_age, min_hits=min_hits)
        self.cache = FeatureCache()
        self.timestep = -1
        # the two crop seed streams; the constructor seed offsets both
        self._seed = seed * 1_000_003
        self._rng_seed = seed * 1_000_003 + self._RNG_OFFSET
        self._use_device_cache = (crop_fn is None if device_cache is None
                                  else device_cache)
        # host-cache one-call frame functions per (t_pad, d_pad) bucket
        self._full_frame_fns = {}
        self._dc = DeviceTrackCache(cache_capacity)
        self._image_mode = bool(getattr(scorer, "image_mode", False))
        # image mode: ((W, H), (out, out)) and the frame functions, set from
        # the first frame's image shapes (a deployment's cameras are fixed)
        self._image_sizes = None
        self._frame_fn = self._pair_frame_fn = None
        if not self._image_mode:
            self._frame_fn = scorer.make_cached_frame_fn(subsample_number)
            self._pair_frame_fn = scorer.make_cached_pair_frame_fn(
                subsample_number)
        self._prev_h = None
        self._prev_xyz = None
        self._prev_d_pad = 8
        self._last_p_pad = 0

    def _record_prune(self):
        """Drop aged-out tracks from the store and both caches, feeding
        their lifetimes to the recorder first."""
        if self.eval_recorder is not None:
            self.eval_recorder.observe_dead(
                [t for t in self.store.tracks.values()
                 if t.age > self.store.max_age])
        pruned = self.store.prune()
        self.cache.drop(pruned)
        self._dc.drop(pruned)

    def end_scene(self):
        """Scene boundary: the live tracks go to the recorder, then the
        tracker resets."""
        if self.eval_recorder is not None:
            self.eval_recorder.end_scene(list(self.store.tracks.values()))
        self.reset()

    def reset(self):
        """New scene. The crop seed streams run on."""
        self.store = TrackStore(max_age=self.store.max_age,
                                min_hits=self.store.min_hits)
        self.cache = FeatureCache()
        self._dc = DeviceTrackCache(self._dc.capacity)
        self._prev_h = self._prev_xyz = None
        self._prev_d_pad = 8
        self._last_p_pad = 0
        self.timestep = -1

    def _next_rng(self) -> torch.Generator:
        """The crop generator of a host-cache embed outside the one-call
        frame, seeded with the next `_rng_seed`."""
        self._rng_seed += 1
        return torch.Generator(device=self.device).manual_seed(
            self._rng_seed)

    def _full_frame_fn(self, t_pad: int, d_pad: int):
        key = (t_pad, d_pad)
        if key not in self._full_frame_fns:
            self._full_frame_fns[key] = self.scorer.make_frame_fn(
                t_pad, d_pad, crop_points=self.subsample_number)
        return self._full_frame_fns[key]

    def _embed_dets(self, frame, boxes_p: np.ndarray, D: int):
        """Host-cache detection embedding: crops (crop_fn, camera crops in
        image mode, or lidar crops from _next_rng), embed, fetch. Returns
        (h (D, N, C), xyz (D, N, 3) or None) as numpy."""
        with torch.no_grad():
            if self.crop_fn is not None:
                crops = self.crop_fn(frame, boxes_p).to(self.device)
            elif self._image_mode:
                images, l2cams, intrins = frame
                images = np.asarray(images)
                self._ensure_image_sizes(images)
                crops = self.scorer._device_crops(
                    *self._to_device(images, np.asarray(l2cams, np.float32),
                                     np.asarray(intrins, np.float32),
                                     boxes_p), *self._image_sizes)
            else:
                pts_d, boxes_d = self._to_device(frame, boxes_p)
                crops, _ = extract_box_crops(self._next_rng(), pts_d,
                                             boxes_d, self.subsample_number)
            xyz_d, h_d = self.scorer.embed(crops)
        return host(h_d[:D]), host(None if xyz_d is None else xyz_d[:D])

    def _step_host_cache(self, frame, boxes_p: np.ndarray, D: int, active):
        """One host-cache frame with tracks: the tracks' features go up,
        the (T, D) float64 logits and the detections' features come down.
        Returns (logits, h_d, xyz_d)."""
        T = len(active)
        h_t, xyz_t = self.cache.gather([t.track_id for t in active])
        if self.crop_fn is None and not self._image_mode:
            # crops + embed + grid in one call
            t_pad = _round_up(T)
            fn = self._full_frame_fn(t_pad, boxes_p.shape[0])

            def pad(x):
                if isinstance(x, torch.Tensor):     # bf16 rows
                    return torch.cat([x, x.new_zeros(
                        (t_pad - T,) + tuple(x.shape[1:]))])
                return np.pad(x, [(0, t_pad - T)] + [(0, 0)] * (x.ndim - 1))
            self._seed += 1
            # the features go up in the model's dtype as the cache holds
            # them (float32, or bf16)
            h_tp, xyz_tp, pts_d, boxes_d = self._to_device(
                pad(h_t), pad(xyz_t).astype(np.float32), frame, boxes_p)
            logits, h_d, xyz_d = fn(h_tp, xyz_tp, (self._seed, pts_d,
                                                   boxes_d))
            logits = host_logits(logits[:T, :D])
            h_d, xyz_d = host(h_d[:D]), host(xyz_d[:D])
        else:
            h_d, xyz_d = self._embed_dets(frame, boxes_p, D)
            if xyz_d is None:                       # image mode: no xyz
                h_t_d, h_d_d = self._to_device(h_t, h_d)
                xyz_t_d = xyz_d_d = None
            else:
                h_t_d, xyz_t_d, h_d_d, xyz_d_d = self._to_device(
                    h_t, xyz_t, h_d, xyz_d)
            logits = host_logits(self.scorer.cost_matrix(
                h_t_d, xyz_t_d, h_d_d, xyz_d_d))
        return logits, h_d, xyz_d

    def _sparse_on(self, n_tracks: int, d_pad: int) -> bool:
        if self.sparse_scoring == "never":
            return False
        if self.sparse_scoring == "always":
            return True
        return _round_up(max(n_tracks, 1)) * d_pad > self._SPARSE_MIN_GRID

    def _pad_pairs(self, pairs: np.ndarray):
        """Bucket-pad a gate-surviving pair list. Sticky buckets: keep the
        larger bucket until the pair count drops to a quarter of it, so P
        fluctuating around a bucket edge does not switch buckets every
        frame. Returns (pair_t, pair_d), each (p_pad,)."""
        P = len(pairs)
        p_pad = _round_up(max(P, 1), sizes=(16, 32, 64, 128, 256, 512))
        last = self._last_p_pad
        if p_pad < last <= 4 * max(P, 1):
            p_pad = last
        self._last_p_pad = p_pad
        pair_t = np.zeros((p_pad,), np.int32)      # pad rows score (0, 0)
        pair_d = np.zeros((p_pad,), np.int32)
        if P:
            pair_t[:P] = pairs[:, 0]
            pair_d[:P] = pairs[:, 1]
        return pair_t, pair_d

    def _to_device(self, *arrays):
        """numpy arrays (or bf16 CPU tensors) to the model's device."""
        return [(a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(a))).to(
            self.device, non_blocking=True) for a in arrays]

    def _ensure_image_sizes(self, images: np.ndarray):
        """((W, H), (out, out)) from the first (ncam, 3, H, W) frame, and
        the image frame functions built for them."""
        if self._image_sizes is None:
            out = int(getattr(self.scorer.model, "image_size", 224))
            self._image_sizes = ((images.shape[3], images.shape[2]),
                                 (out, out))
            self._frame_fn = self.scorer.make_cached_image_frame_fn(
                *self._image_sizes)
            self._pair_frame_fn = self.scorer.make_cached_image_pair_frame_fn(
                *self._image_sizes)
        return self._image_sizes

    def _step_device_cached_image(self, frame, boxes_p: np.ndarray, D: int,
                                  active,
                                  pairs: Optional[np.ndarray] = None):
        """One device frame of the image branch: box projection + camera
        crops + ViT embed + grid (or gated pair-list) scoring against the
        device-resident track tokens. Only the logits come back; the frame's
        images go up as they are (uint8 frames at a quarter of the float32
        bytes). `frame` is (images (ncam, 3, H, W), lidar2cams (ncam, 4, 4),
        intrinsics (ncam, 3, 3)). Returns (T, D) float64 logits or None."""
        images, l2cams, intrins = frame
        images = np.asarray(images)
        l2cams = np.asarray(l2cams, np.float32)
        intrins = np.asarray(intrins, np.float32)
        self._ensure_image_sizes(images)
        dc = self._dc
        d_pad = boxes_p.shape[0]
        if dc.h_buf is None:
            # first frame of the scene: embed only
            img_d, l2c_d, k_d, boxes_d = self._to_device(images, l2cams,
                                                         intrins, boxes_p)
            with torch.no_grad():
                crops = self.scorer._device_crops(img_d, l2c_d, k_d, boxes_d,
                                                  *self._image_sizes)
                _, h_d = self.scorer.embed(crops)
            dc.ensure(h_d.shape[1], h_d.shape[2], h_d.dtype, h_d.device,
                      with_xyz=False)
            self._prev_h, self._prev_d_pad = h_d, d_pad
            return None
        T = len(active)
        t_pad = _round_up(max(T, 1))
        slot_idx = np.full((t_pad,), dc.capacity, np.int64)
        for i, t in enumerate(active):
            slot_idx[i] = dc.slot(t.track_id)
        upd_src, upd_dst = dc.take_updates(self._prev_d_pad)
        if pairs is None:
            (upd_src_d, upd_dst_d, slot_idx_d, img_d, l2c_d, k_d,
             boxes_d) = self._to_device(upd_src, upd_dst, slot_idx, images,
                                        l2cams, intrins, boxes_p)
            dc.h_buf, logits_dev, h_d = self._frame_fn(
                dc.h_buf, self._prev_h, upd_src_d, upd_dst_d, slot_idx_d,
                img_d, l2c_d, k_d, boxes_d)
            self._prev_h, self._prev_d_pad = h_d, d_pad
            if not T:
                return None
            return host_logits(logits_dev)[:T, :D]
        P = len(pairs)
        pair_t, pair_d = self._pad_pairs(pairs)
        (upd_src_d, upd_dst_d, slot_idx_d, pair_t_d, pair_d_d, img_d, l2c_d,
         k_d, boxes_d) = self._to_device(upd_src, upd_dst, slot_idx, pair_t,
                                         pair_d, images, l2cams, intrins,
                                         boxes_p)
        dc.h_buf, logits_dev, h_d = self._pair_frame_fn(
            dc.h_buf, self._prev_h, upd_src_d, upd_dst_d, slot_idx_d,
            pair_t_d, pair_d_d, img_d, l2c_d, k_d, boxes_d)
        self._prev_h, self._prev_d_pad = h_d, d_pad
        logits = np.full((T, D), -np.inf, np.float64)
        if P:
            logits[pairs[:, 0], pairs[:, 1]] = (
                host_logits(logits_dev)[:P])
        return logits

    def _step_device_cached(self, pts: np.ndarray, boxes_p: np.ndarray,
                            D: int, active, pairs: Optional[np.ndarray] = None):
        """One device frame; returns (T, D) float64 logits or None. With
        `pairs` ((P, 2) gate survivors) only those pairs are scored and the
        rest of the matrix is -inf."""
        dc = self._dc
        d_pad = boxes_p.shape[0]
        self._seed += 1
        if dc.h_buf is None:
            # first frame of the scene: embed only
            pts_d, boxes_d = self._to_device(pts, boxes_p)
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            with torch.no_grad():
                crops, _ = extract_box_crops(gen, pts_d, boxes_d,
                                             self.subsample_number)
                xyz_d, h_d = self.scorer.embed(crops)
            dc.ensure(h_d.shape[1], h_d.shape[2], h_d.dtype, h_d.device)
            self._prev_h, self._prev_xyz, self._prev_d_pad = h_d, xyz_d, d_pad
            return None
        T = len(active)
        t_pad = _round_up(max(T, 1))
        slot_idx = np.full((t_pad,), dc.capacity, np.int64)
        for i, t in enumerate(active):
            slot_idx[i] = dc.slot(t.track_id)
        upd_src, upd_dst = dc.take_updates(self._prev_d_pad)
        if pairs is None:
            upd_src_d, upd_dst_d, slot_idx_d, pts_d, boxes_d = self._to_device(
                upd_src, upd_dst, slot_idx, pts, boxes_p)
            dc.h_buf, dc.xyz_buf, logits_dev, h_d, xyz_d = self._frame_fn(
                dc.h_buf, dc.xyz_buf, self._prev_h, self._prev_xyz,
                upd_src_d, upd_dst_d, slot_idx_d, self._seed, pts_d, boxes_d)
            self._prev_h, self._prev_xyz, self._prev_d_pad = h_d, xyz_d, d_pad
            if not T:
                return None
            return host_logits(logits_dev)[:T, :D]
        P = len(pairs)
        pair_t, pair_d = self._pad_pairs(pairs)
        (upd_src_d, upd_dst_d, slot_idx_d, pair_t_d, pair_d_d, pts_d,
         boxes_d) = self._to_device(upd_src, upd_dst, slot_idx, pair_t,
                                    pair_d, pts, boxes_p)
        dc.h_buf, dc.xyz_buf, logits_dev, h_d, xyz_d = self._pair_frame_fn(
            dc.h_buf, dc.xyz_buf, self._prev_h, self._prev_xyz,
            upd_src_d, upd_dst_d, slot_idx_d, pair_t_d, pair_d_d,
            self._seed, pts_d, boxes_d)
        self._prev_h, self._prev_xyz, self._prev_d_pad = h_d, xyz_d, d_pad
        logits = np.full((T, D), -np.inf, np.float64)
        if P:
            logits[pairs[:, 0], pairs[:, 1]] = (
                host_logits(logits_dev)[:P])
        return logits

    def _cache_row(self, track_id: int, h_d: np.ndarray,
                   xyz_d: Optional[np.ndarray], di: int) -> None:
        self.cache.update([track_id], h_d[di:di + 1],
                          None if xyz_d is None else xyz_d[di:di + 1])

    def _nms(self, det_boxes: np.ndarray, det_scores: np.ndarray
             ) -> np.ndarray:
        """Indices of the detections BEV NMS keeps, in order of falling
        score (every detection may be kept: max_out = D)."""
        keep = nms_bev(*self._to_device(det_boxes, det_scores),
                       self.nms_threshold, len(det_boxes)).numpy()
        return keep[keep >= 0]

    def step(self, points: np.ndarray, det_boxes: np.ndarray,
             det_scores: np.ndarray, det_labels: np.ndarray,
             det_gt_ids: Optional[np.ndarray] = None) -> List[Track]:
        """Process one frame; returns the confirmed tracks.

        points (N, 3+) lidar sweep, or in image mode the camera frame
        (images (ncam, 3, H, W), lidar2cams (ncam, 4, 4), intrinsics
        (ncam, 3, 3)), or with a crop_fn whatever it takes; det_boxes (D, 7)
        [cx cy cz dx dy dz yaw]; det_scores (D,); det_labels (D,) int class
        ids; det_gt_ids optional (D,) gt object ids (-1: a false positive)
        for the eval recorder."""
        self.timestep += 1
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 7)
        det_scores = np.asarray(det_scores, np.float32).reshape(-1)
        det_labels = np.asarray(det_labels, np.int64).reshape(-1)
        if det_gt_ids is not None:
            det_gt_ids = np.asarray(det_gt_ids, np.int64).reshape(-1)

        if self.nms_threshold is not None and len(det_boxes) > 1:
            keep = self._nms(det_boxes, det_scores)
            det_boxes, det_scores, det_labels = (
                det_boxes[keep], det_scores[keep], det_labels[keep])
            if det_gt_ids is not None:
                det_gt_ids = det_gt_ids[keep]

        D = len(det_boxes)
        if D == 0:
            for t in self.store.tracks.values():
                t.missed()
            self._record_prune()
            return self.store.outputs()

        if self._image_mode or self.crop_fn is not None:
            pts = points              # the camera frame, or crop_fn's input
        else:
            n_pad = _round_up(max(len(points), 1), sizes=SWEEP_SIZES)
            pts = np.full((n_pad, 3), 1e6, np.float32)   # far from any box
            pts[:len(points)] = np.asarray(points, np.float32)[:, :3]
        d_pad = _round_up(D)
        boxes_p = np.full((d_pad, 7), 1e6, np.float32)
        boxes_p[:D] = det_boxes

        active = self.store.active()
        use_dc = self._use_device_cache and self.crop_fn is None
        h_d = xyz_d = None
        if use_dc:
            logits, gate = self._step_device(pts, boxes_p, D, active,
                                             det_boxes, det_labels)
        elif active:
            logits, h_d, xyz_d = self._step_host_cache(pts, boxes_p, D,
                                                       active)
            gate = None
        else:
            h_d, xyz_d = self._embed_dets(pts, boxes_p, D)
            logits = None
        if active and logits is not None:
            ok = (np.array([t.cls for t in active])[:, None]
                  == det_labels[None, :])
            logits[~ok] = -np.inf
            cost = 1.0 - 1.0 / (1.0 + np.exp(-logits))
            if gate is None:
                pred_boxes = np.stack([t.predict(self.timestep)
                                       for t in active])
                gate = center_distance_gate(pred_boxes, det_boxes,
                                            self.max_distance)
            matches, unmatched_t, unmatched_d = associate(
                cost, threshold=self.match_threshold, method=self.method,
                gate=gate)
        else:
            matches, unmatched_t, unmatched_d = [], [], list(range(D))

        matched_rec, newborn_rec = [], []
        for ti, di in matches:
            t = active[ti]
            t.update(det_boxes[di], det_scores[di], self.timestep)
            if use_dc:
                # features stay on the device: scattered at the next frame
                self._dc.queue_update(di, self._dc.slot(t.track_id))
            else:
                self._cache_row(t.track_id, h_d, xyz_d, di)
            if det_gt_ids is not None:
                matched_rec.append((t.track_id, det_gt_ids[di],
                                    det_labels[di]))
        for ti in unmatched_t:
            active[ti].missed()
        for di in unmatched_d:
            t = self.store.new_track(det_labels[di], det_boxes[di],
                                     det_scores[di], self.timestep)
            if use_dc:
                self._dc.queue_update(di, self._dc.assign(t.track_id))
            else:
                self._cache_row(t.track_id, h_d, xyz_d, di)
            if det_gt_ids is not None:
                newborn_rec.append((t.track_id, det_gt_ids[di],
                                    det_labels[di]))
        if self.eval_recorder is not None and det_gt_ids is not None:
            self.eval_recorder.observe_frame(
                matched_rec, newborn_rec,
                [active[ti].track_id for ti in unmatched_t],
                unmatched_det_gt=[])
        self._record_prune()
        return self.store.outputs()

    def _step_device(self, pts, boxes_p: np.ndarray, D: int, active,
                     det_boxes: np.ndarray, det_labels: np.ndarray):
        """One device-cache frame: (logits (T, D) float64 or None, the BEV
        gate if it was computed before dispatch, else None)."""
        d_pad = boxes_p.shape[0]
        # gate before dispatch when sparse scoring applies: the class + BEV
        # masks are host math on boxes, known before any device work
        pairs = gate = None
        if (active and self._dc.h_buf is not None
                and self._sparse_on(len(active), d_pad)):
            pred_boxes = np.stack([t.predict(self.timestep) for t in active])
            gate = center_distance_gate(pred_boxes, det_boxes,
                                        self.max_distance)
            ok = (np.array([t.cls for t in active])[:, None]
                  == det_labels[None, :])
            pairs = np.argwhere(gate & ok).astype(np.int32)
            if 4 * len(pairs) > _round_up(len(active)) * d_pad:
                pairs = None            # dense gate: the grid kernel wins
        step_fn = (self._step_device_cached_image if self._image_mode
                   else self._step_device_cached)
        return step_fn(pts, boxes_p, D, active, pairs=pairs), gate
