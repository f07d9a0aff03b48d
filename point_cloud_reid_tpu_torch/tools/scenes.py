"""Scene generators, seeded kNN clouds, the image model of the tools and
the card label, shared by chip_smoke.py and the tools."""
from __future__ import annotations

import subprocess

import numpy as np


def bench_scene(n_obj: int, pts_per_obj: int, frames: int, seed: int = 0):
    """Yields (points, boxes, scores, labels) per frame: the bench's
    drifting-objects scene (bench.py _bench_tracker_e2e: n_obj objects of
    pts_per_obj points, 2 m boxes, 0.2 m/frame drift, one class)."""
    rs = np.random.RandomState(seed)
    centers = (rs.rand(n_obj, 3) * 40 - 20).astype(np.float32)
    centers[:, 2] = 0.0
    for _ in range(frames):
        centers += rs.randn(n_obj, 3).astype(np.float32) * 0.2
        boxes = np.concatenate(
            [centers, np.full((n_obj, 3), 2.0, np.float32),
             np.zeros((n_obj, 1), np.float32)], axis=1)
        pts = (np.repeat(centers, pts_per_obj, axis=0)
               + rs.randn(n_obj * pts_per_obj, 3).astype(np.float32) * 0.5)
        yield pts, boxes, np.ones(n_obj, np.float32), np.zeros(n_obj, np.int64)


def knn_cloud(kind: str, B: int, N: int, seed: int, C: int = 3
              ) -> np.ndarray:
    """(B, N, C) float32 crops (or features) for the kNN and FPS checks.
    'exact': multiples of 1/64 in [-2, 2), so every product and sum of a
    squared distance (to C = 256) is exact in float32 and the kernel and
    the plain version see identical distances, full of ties;
    'duplicates': 'exact' points resampled with replacement, as crops
    are; 'random': Gaussian floats."""
    rs = np.random.RandomState(seed)
    if kind == "random":
        return (rs.randn(B, N, C) * 0.6).astype(np.float32)
    xyz = rs.randint(-128, 128, (B, N, C)).astype(np.float32) / 64.0
    if kind == "duplicates":
        xyz = xyz[np.arange(B)[:, None], rs.randint(0, N // 3, (B, N))]
    return xyz


IMAGE_EXPERIMENT = "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"


def camera_ring():
    """Six cameras in a ring (nuScenes geometry: 1600 x 900, 60 degrees
    apart): (lidar2cams (6, 4, 4), intrinsics (6, 3, 3)), as bench.py
    camera_ring."""
    l2cs, Ks = [], []
    for k in range(6):
        a = k * np.pi / 3
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([np.sin(a), -np.cos(a), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        l2c = np.eye(4, dtype=np.float32)
        l2c[:3, :3] = np.stack([right, down, fwd])
        l2cs.append(l2c)
        Ks.append(np.array([[800, 0, 800], [0, 800, 450], [0, 0, 1]],
                           np.float32))
    return np.stack(l2cs), np.stack(Ks)


def image_scene(n_obj: int, frames: int, seed: int = 0,
                image_hw=(900, 1600)):
    """Yields ((images, lidar2cams, intrinsics), boxes, scores, labels) per
    frame: the bench's image scene (bench.py _bench_image_tracker_e2e: six
    uint8 cameras of random pixels, n_obj 2 m boxes 8-28 m around the ring,
    0.2 m/frame drift, one class). The images are the same every frame."""
    l2cs, Ks = camera_ring()
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (6, 3) + tuple(image_hw), dtype=np.uint8)
    ang = rs.rand(n_obj) * 2 * np.pi
    rad = 8.0 + rs.rand(n_obj) * 20.0
    centers = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                        np.zeros(n_obj)], axis=1).astype(np.float32)
    for _ in range(frames):
        centers[:, :2] += rs.randn(n_obj, 2).astype(np.float32) * 0.2
        boxes = np.concatenate(
            [centers, np.full((n_obj, 3), 2.0, np.float32),
             np.zeros((n_obj, 1), np.float32)], axis=1)
        yield ((images, l2cs, Ks), boxes, np.ones(n_obj, np.float32),
               np.zeros(n_obj, np.int64))


def build_tracker_model(image: bool, device, seed: int = 0, dtype=None,
                        experiment=None):
    """The model a tool tracks with, at full width with seeded random
    weights: the point flagship, or the image model of IMAGE_EXPERIMENT
    (deit-tiny-no-pt, 197 tokens), or the leaf `experiment` names; `dtype`
    its compute dtype (float32 by default)."""
    import torch

    from ..configs import get_experiment, point_transformer_point_cat
    from ..models import build_model
    cfg = (get_experiment(experiment)["model"] if experiment
           else get_experiment(IMAGE_EXPERIMENT)["model"] if image
           else point_transformer_point_cat())
    return build_model(cfg, device=device,
                       generator=torch.Generator().manual_seed(seed),
                       dtype=dtype or torch.float32)


def card_name() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]
