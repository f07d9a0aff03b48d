"""Shared set-up of the tracker-era zoo's parity tests: each config of
point_cloud_reid_tpu_torch/configs/zoo.py at test size, built from the
same --set strings on both sides (the port's get_experiment and the JAX
package's), with the port's seeded weights handed to JAX.

Test size: the point-transformer leaves at mul 1, nsample 8 and
backbone_list [16, 8, 4] (d stays 64), the local stages at knum 6, the
VN-DGCNN backbone at n_knn 6; crops of N_PTS points.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

N_PTS = 32
TEST_SETS = ["model.backbone.mul=1", "model.backbone.nsample=[8,8,8]",
             "model.backbone_list=[16,8,4]"]


def zoo_sets(name: str) -> tuple:
    """(leaf, the config's --set list at test size)."""
    from point_cloud_reid_tpu_torch.configs.zoo import ZOO
    leaf, sets = ZOO[name]
    if name == "vn_dgcnn":
        return leaf, sets + ["model.backbone.n_knn=6"]
    extra = list(TEST_SETS)
    if name.startswith("xcorr"):
        extra += ["model.local_stage1.knum=6", "model.local_stage2.knum=6"]
    return leaf, sets + extra


def zoo_cfgs(name: str, knobs=()) -> tuple:
    """(the port's model config, the JAX package's) of a zoo config, with
    more --set strings `knobs`."""
    from point_cloud_reid_tpu.configs import get_experiment as jget
    from point_cloud_reid_tpu_torch.configs import get_experiment
    leaf, sets = zoo_sets(name)
    sets = sets + list(knobs)
    return (get_experiment(leaf, set_options=sets)["model"],
            jget(leaf, set_options=sets)["model"])


@functools.lru_cache(maxsize=None)
def zoo_models(name: str, jax_dtype: str = "float32"):
    """(JAX model, its variables as jnp arrays, the port's model in
    jax_dtype) sharing the port's seed-0 weights; cached: callers must not
    train the port's model."""
    import jax
    import jax.numpy as jnp
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.convert import to_jax_variables
    from point_cloud_reid_tpu_torch.models import build_model
    cfg, jcfg = zoo_cfgs(name)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(0))
    dt = getattr(jnp, jax_dtype)
    jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                   to_jax_variables(tmodel))
    if jax_dtype == "float64":
        tmodel = tmodel.double()
    return jax_build(jcfg, dtype=dt), jvars, tmodel


def dup_crops(seed: int, B: int = 5, N: int = N_PTS, dups: int = 6):
    """(B, N, 3) crops whose last `dups` points repeat earlier ones."""
    rs = np.random.RandomState(seed)
    base = (rs.randn(B, N - dups, 3) * 0.6).astype(np.float32)
    return np.concatenate([base, base[:, rs.randint(0, N - dups, dups)]], 1)


# the pairs a test scores from nt = 3 tracks and nd = 5 detections
T_IDX, D_IDX = np.array([0, 2, 1, 2, 0]), np.array([4, 0, 1, 3, 3])
