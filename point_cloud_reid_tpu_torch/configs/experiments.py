"""Experiment leaves: 4-axis composition + named experiment registry.

Port of point_cloud_reid_tpu/configs/experiments.py, every leaf of its
registry: the point families on nuScenes and Waymo (the point-transformer
flagship, PointNet, DGCNN, the concat and xcorr-baseline baselines and the
scaled 1.5M and 7M models) with their testing_ and _accumN twins, the
point-count ablations of the flagship, PointNet and DGCNN, the flagship's
scaling_ leaves and the ablations' aliases, the image (rgb_*) leaves, their
testing_ twins and the three image_* aliases:
compose(dataset, model, schedule, runtime),
schedule('cyclic_500e_lr3e-4_norm1_accum2') parsing the reference's
schedule-file names, and the dotted-path --set overrides.
"""
from __future__ import annotations

import ast
import re
from typing import Any, Callable, Dict, Optional

from ..train.schedules import ScheduleConfig
from . import datasets as D
from . import models as M


def schedule(name: str) -> ScheduleConfig:
    """Parse 'cyclic_{E}e_lr{LR}[_norm1][_accumN]' / 'cosine' names."""
    if name.startswith("cosine"):
        return ScheduleConfig(policy="cosine")
    m = re.match(r"cyclic_(\d+)e_lr([0-9.e-]+?)(_norm1)?(_accum(\d+))?$", name)
    if not m:
        raise ValueError(f"unknown schedule name: {name}")
    return ScheduleConfig(
        policy="cyclic",
        max_epochs=int(m.group(1)),
        lr=float(m.group(2)),
        grad_clip_norm=1.0 if m.group(3) else 35.0,
        cumulative_iters=int(m.group(5)) if m.group(5) else 1,
    )


def runtime(work_dir: Optional[str] = None, seed: int = 66,
            eval_interval: int = 25, checkpoint_interval: int = 5,
            log_interval: int = 50, validate: bool = False,
            deterministic: bool = False) -> Dict[str, Any]:
    """Runtime axis (reidentification_runtime.py: interval=5 ckpt, seed 66;
    *_testing.py flips validate/deterministic)."""
    return dict(work_dir=work_dir, seed=seed, eval_interval=eval_interval,
                checkpoint_interval=checkpoint_interval,
                log_interval=log_interval, validate=validate,
                deterministic=deterministic)


def compose(dataset: Dict[str, Any], model: Dict[str, Any],
            sched: ScheduleConfig, rt: Optional[Dict[str, Any]] = None,
            losses_to_use: Optional[Dict[str, bool]] = None,
            alpha: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """One experiment dict: the unit tools/train.py consumes. Released
    configs train with the match loss only."""
    return dict(dataset=dataset, model=model, schedule=sched,
                runtime=rt or runtime(),
                losses_to_use=losses_to_use or dict(match=True),
                alpha=alpha or {})


def _pts_leaf(dataset_fn, model_fn, num_classes: int, max_epochs: int,
              accum: int = 1):
    """A point leaf of the JAX registry's point-leaf factory
    (experiments.py:154-166): dataset (subsample_sparse from `pts`), model,
    'cyclic_{E}e_lr3e-4[_accumN]'."""
    def fn(pts=None, epochs=None, **kw) -> Dict[str, Any]:
        if pts:
            kw["subsample_sparse"] = pts
        sname = f"cyclic_{epochs or max_epochs}e_lr3e-4" + (
            f"_accum{accum}" if accum > 1 else "")
        return compose(dataset_fn(**kw), model_fn(num_classes),
                       schedule(sname))
    return fn


def _testing(train_fn):
    """testing_* leaf: same composition, eval-only runtime."""
    def fn(**kw):
        cfg = train_fn(**kw)
        cfg["runtime"] = dict(cfg["runtime"], validate=True,
                              deterministic=True, eval_only=True)
        return cfg
    return fn


def _fixed(dataset_fn, model_cfg, sched, **dataset_kw):
    """A leaf of one dataset setting, model and schedule (the ablations,
    scaling runs and aliases)."""
    def fn(**kw):
        return compose(dataset_fn(**dataset_kw, **kw), model_cfg(), sched())
    return fn


# the point models; as in JAX, the baselines and the scaled ones ignore the
# class count (they have no aux heads)
_PTS_MODELS = {
    "point-transformer_point-cat": lambda nc: M.point_transformer_point_cat(
        num_classes=nc),
    "pointnet_point-cat": lambda nc: M.pointnet_point_cat(num_classes=nc),
    "dgcnn_point-cat": lambda nc: M.dgcnn_point_cat(num_classes=nc),
    "point-transformer_baseline": lambda nc: M.point_transformer_baseline(),
    "point-transformer_baseline-stnet":
        lambda nc: M.point_transformer_baseline(stnet=True),
    "point-transformer-1.5M_point-cat":
        lambda nc: M.point_transformer_scaled("1.5M"),
    "point-transformer-7M_point-cat":
        lambda nc: M.point_transformer_scaled("7M"),
}
_FLAGSHIP = "point-transformer_point-cat"

EXPERIMENTS: Dict[str, Callable[..., Dict[str, Any]]] = {}
# point leaves: nuScenes (500e grid) and Waymo (400e grid)
for _ds, _ds_fn, _nc, _e in (("nus", D.nuscenes_pts, 10, 500),
                             ("waymo", D.waymo_pts, 6, 400)):
    for _m, _m_fn in _PTS_MODELS.items():
        _name = f"pts_{_m}_{_ds}_det_4x256_{_e}e"
        EXPERIMENTS[_name] = _pts_leaf(_ds_fn, _m_fn, _nc, _e)
        EXPERIMENTS["testing_" + _name] = _testing(EXPERIMENTS[_name])
        for _a in (2, 4, 8):
            EXPERIMENTS[f"{_name}_accum{_a}"] = _pts_leaf(_ds_fn, _m_fn, _nc,
                                                         _e, _a)
    # point-count ablations (reid_{waymo,nuscenes}_pts/num_point_ablation/*;
    # three backbone families)
    for _m in (_FLAGSHIP, "pointnet_point-cat", "dgcnn_point-cat"):
        for _n in (160, 192, 224, 256, 512, 1024, 2048):
            EXPERIMENTS[f"pts_{_m}_{_ds}_det_4x256_{_e}e_{_n}pts"] = _fixed(
                _ds_fn, lambda m=_PTS_MODELS[_m], nc=_nc: m(nc),
                lambda e=_e: schedule(f"cyclic_{e}e_lr3e-4"),
                subsample_sparse=_n)

# scaling runs (waymo 800/1600/3200e, nuScenes 1000/2000/4000e); the
# nuScenes ones build a bare ScheduleConfig, as JAX does
for _e in (800, 1600, 3200):
    EXPERIMENTS[f"scaling_pts_{_FLAGSHIP}_waymo_det_4x256_{_e}e"] = _fixed(
        D.waymo_pts, lambda: M.point_transformer_point_cat(num_classes=6),
        lambda e=_e: schedule(f"cyclic_{e}e_lr3e-4"))
for _e in (1000, 2000, 4000):
    EXPERIMENTS[f"scaling_pts_{_FLAGSHIP}_nus_det_4x256_{_e}e"] = _fixed(
        D.nuscenes_pts, M.point_transformer_point_cat,
        lambda e=_e: ScheduleConfig(policy="cyclic", max_epochs=e, lr=3e-4))

# the round-1 names of the ablations
for _n in (256, 512):
    EXPERIMENTS[f"pts_{_FLAGSHIP}_{_n}pts_nus_det_4x256_500e"] = _fixed(
        D.nuscenes_pts, M.point_transformer_point_cat,
        lambda: schedule("cyclic_500e_lr3e-4"), subsample_sparse=_n)
for _n in (160, 256, 512, 1024, 2048):
    EXPERIMENTS[f"pts_{_FLAGSHIP}_waymo_{_n}pts"] = EXPERIMENTS[
        f"pts_{_FLAGSHIP}_waymo_det_4x256_400e_{_n}pts"]


def _image_leaf(variant: str, dataset_fn, num_classes: int, epochs: int):
    def fn(**kw):
        cfg = compose(
            dataset_fn(**kw),
            M.image_deit_point_cat(variant, num_classes=num_classes,
                                   pretrained="no-pt" not in variant),
            schedule(f"cyclic_{epochs}e_lr1e-5"),
            losses_to_use=dict(match=True, cls=True, fp=True, vis=True,
                               triplet=True))
        # image leaves set triplet_loss=dict(margin=10, p=2); points use 0.2
        cfg["triplet_margin"] = 10.0
        return cfg
    return fn


# image leaves (reid_nuscenes_image/, reid_waymo_image/)
for _ds, _ds_fn, _nc in (("nus", D.nuscenes_image, 10),
                         ("waymo", D.waymo_image, 6)):
    for _v, _tag in (("deit-tiny", "deit-tiny_point-cat_pt"),
                     ("deit-base", "deit-base_point-cat_pt"),
                     ("deit-tiny-no-pt", "deit-tiny_point-cat_r"),
                     ("deit-base-no-pt", "deit-base_point-cat_r"),
                     ("beit", "beit-base-lin-xcorr")):
        _name = f"rgb_{_tag}_{_ds}_det_4x60_200e"
        EXPERIMENTS[_name] = _image_leaf(_v, _ds_fn, _nc, 200)
        EXPERIMENTS["testing_" + _name] = _testing(EXPERIMENTS[_name])
for _alias, _name in (
        ("image_deit-tiny_point-cat", "rgb_deit-tiny_point-cat_pt"),
        ("image_deit-base_point-cat", "rgb_deit-base_point-cat_pt"),
        ("image_beit-base", "rgb_beit-base-lin-xcorr")):
    EXPERIMENTS[f"{_alias}_nus_det_4x60_200e"] = EXPERIMENTS[
        f"{_name}_nus_det_4x60_200e"]


def _parse_value(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        r = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
    # bare comma lists ('64,32,16') literal-eval to tuples; configs use lists
    return list(r) if isinstance(r, tuple) else r


def apply_overrides(cfg: Dict[str, Any], assignments) -> Dict[str, Any]:
    """In-place dotted-path config overrides ('key.sub=val' with
    literal-eval values), through nested dicts and the ScheduleConfig
    dataclass: `losses_to_use.match=false`, `schedule.lr=1e-4`,
    `model.backbone.mul=2`, `model.knn_method=pallas`.

    Existing keys are replaced; a new leaf key is allowed only on a
    component dict (one with a 'type'), whose factory reads optional knobs
    with cfg.get(). Anything else unknown raises."""
    for assignment in assignments or ():
        if "=" not in assignment:
            raise ValueError(f"override must be key.path=value, "
                             f"got {assignment!r}")
        path, _, raw = assignment.partition("=")
        keys = path.strip().split(".")
        node = cfg
        for k in keys[:-1]:
            node = node[k] if isinstance(node, dict) else getattr(node, k)
        leaf = keys[-1]
        val = _parse_value(raw.strip())
        if isinstance(node, dict):
            if leaf not in node and "type" not in node:
                raise KeyError(f"unknown config key {path!r} "
                               f"(no {leaf!r} in {sorted(node)})")
            node[leaf] = val
        else:
            if not hasattr(node, leaf):
                raise AttributeError(f"unknown config key {path!r}")
            setattr(node, leaf, val)
    return cfg


def get_experiment(name: str, set_options=None, **overrides) -> Dict[str, Any]:
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name}; known: "
                       f"{sorted(EXPERIMENTS)}")
    return apply_overrides(EXPERIMENTS[name](**overrides), set_options)
