"""How far a zoo head's bf16 logits lie from its float32 logits, in the
JAX package and in the port, at full width on the CPU.

    JAX_PLATFORMS=cpu python -m tests._torch_zoo_bf16_gap [NAME ...] [--crops 12]

For each config of point_cloud_reid_tpu_torch/configs/zoo.py named (by
default 'xcorr' and 'cosine'), at the leaf's full width from the port's
seed-0 weights, it scores the grid of `--crops` x `--crops` pairs of
128-point crops (numpy seed 1) four ways: the JAX package at float32 and
bf16 (jitted), the port at float32 and bf16. It prints one JSON line a
config: max |bf16 - float32| / max(1, max |float32|) within each package,
the port's bf16 logits against JAX's, and the port's float32 ones against
JAX's. chip_smoke.py phase 13 holds a bf16 frame's logits against the
float32 port's; this says what gap the JAX package itself has there.
"""
from __future__ import annotations

import argparse
import copy
import json

import numpy as np


def gaps(name: str, crops: int) -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from point_cloud_reid_tpu.configs import get_experiment as jget
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.configs.zoo import ZOO
    from point_cloud_reid_tpu_torch.convert import to_jax_variables
    from point_cloud_reid_tpu_torch.models import build_model
    leaf, sets = ZOO[name]
    cfg = get_experiment(leaf, set_options=sets)["model"]
    x = (np.random.RandomState(1).randn(crops, 128, 3) * 0.6).astype(
        np.float32)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(copy.deepcopy(cfg), dtype=dtype,
                            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            xyz, h = model.embed(torch.from_numpy(x))
            out[("port", dtype)] = model.match_logits_grid(
                h, xyz, h, xyz).float().numpy()
        jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(model))
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        jmodel = jax_build(jget(leaf, set_options=sets)["model"], dtype=jdt)

        @jax.jit
        def grid(variables, x, jmodel=jmodel):
            xyz, h = jmodel.apply(variables, x, train=False, method="embed")
            return jmodel.apply(variables, h, xyz, h, xyz,
                                method="match_logits_grid")
        out[("jax", dtype)] = np.asarray(grid(jvars, jnp.asarray(x)),
                                         np.float32)

    def rel(a, b):
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    f32, b16 = torch.float32, torch.bfloat16
    return dict(config=name, pairs=crops * crops,
                jax_bf16_vs_jax_f32=rel(out["jax", b16], out["jax", f32]),
                port_bf16_vs_port_f32=rel(out["port", b16], out["port", f32]),
                port_bf16_vs_jax_bf16=rel(out["port", b16], out["jax", b16]),
                port_f32_vs_jax_f32=rel(out["port", f32], out["jax", f32]),
                max_abs_logit=float(np.abs(out["jax", f32]).max()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("names", nargs="*", default=["xcorr", "cosine"])
    p.add_argument("--crops", type=int, default=12)
    args = p.parse_args(argv)
    for name in args.names:
        print(json.dumps(gaps(name, args.crops)), flush=True)


if __name__ == "__main__":
    main()
