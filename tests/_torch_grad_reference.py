"""Which JAX gradient the port's gradient tests may be held against.

    JAX_PLATFORMS=cpu python -m tests._torch_grad_reference

On the tiny flagship of tests/_torch_port.py (one batch of 6 pairs x 32
points with duplicated points, losses match + kl + triplet + cls + fp,
plain kNN and attention) it computes the gradient of the training loss with
respect to every parameter six ways and prints one JSON line:

  jax_f32, jax_f64        the JAX package op by op, float32 and float64
  jax_f64_jit             the same float64 function under jax.jit
  jax_f64_jit_no_algsimp  the same, compiled with XLA's algebraic
                          simplifier off (NO_ALGSIMP)
  port_f32, port_f64      the port, float32 and float64

each as its global norm and its largest deviation from port_f64, relative
to the largest entry of port_f64. A second JSON line narrows the gap between
jax_f64 and jax_f64_jit down to one stage: the first SA stage's three
conv + flax BatchNorm (batch statistics) + ReLU blocks followed by the max
over the neighbours, on random input, with the directional derivative of
each mode beside a central finite difference. On jax 0.9.0's CPU backend
the default compilation fails that check (the gradients that flow back
through the last block into the first two are wrong) and the op-by-op and
the no-algsimp compilations pass it; the same chain ending in a sum instead
of the max passes it in every mode. tests/test_torch_train_model.py and
tests/test_torch_train_step.py therefore run the JAX side in float64 and
compile its train step with NO_ALGSIMP.
"""
from __future__ import annotations

import copy
import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from point_cloud_reid_tpu.models import build_model as jax_build
from point_cloud_reid_tpu.models.layers import ConvBNReLU
from point_cloud_reid_tpu.train import losses as jl
from point_cloud_reid_tpu_torch.train.losses import reid_losses
from tests._torch_port import (NO_ALGSIMP, jax_batch, jax_negatives,
                               pair_batch, port_flat, tiny_cfg, torch_batch,
                               train_models)

USE = dict(match=True, kl=True, triplet=True, cls=True, fp=True)
ALPHA = dict(kl=0.1, cls=0.5)


def compiled(fn, *args):
    """fn(*args) through jax.jit with the algebraic simplifier off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_ALGSIMP)(*args)


def model_gradients() -> dict:
    batch = pair_batch(30)
    grads = {}
    _, jvars, tmodel = train_models(jax_dtype=np.float64)
    key = jax.random.PRNGKey(7)
    neg = torch.from_numpy(jax_negatives(key, batch["id_1"], batch["id_2"],
                                         5))
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        jmodel = jax_build(copy.deepcopy(tiny_cfg()), dtype=dt)
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), jvars)
        jb = jax_batch(batch, dt)

        def loss_fn(params):
            out, _ = jmodel.apply(
                {"params": params, "batch_stats": jv["batch_stats"]}, jb,
                train=True, mutable=["batch_stats"])
            return jl.reid_losses(out, jb, losses_to_use=USE, alpha=ALPHA,
                                  rng=key, pool_type=jmodel.pool_type)[0]

        grads["jax_" + name] = port_flat(jax.grad(loss_fn)(jv["params"]))
        if name == "f64":
            grads["jax_f64_jit"] = port_flat(
                jax.jit(jax.grad(loss_fn))(jv["params"]))
            grads["jax_f64_jit_no_algsimp"] = port_flat(
                compiled(jax.grad(loss_fn), jv["params"]))
        probe = copy.deepcopy(tmodel).to(
            torch.float64 if name == "f64" else torch.float32)
        probe.requires_grad_(True)
        tb = {k: v.to(probe.cls_head[1].weight.dtype)
              if v.is_floating_point() else v
              for k, v in torch_batch(batch).items()}
        loss, _ = reid_losses(probe(tb, train=True), tb, USE, ALPHA,
                              pool_type=probe.pool_type, neg_idx=neg)
        loss.backward()
        grads["port_" + name] = {
            k: (p.grad if p.grad is not None
                else torch.zeros_like(p)).double().numpy()
            for k, p in probe.named_parameters()}
    truth = grads["port_f64"]
    scale = max(float(np.abs(v).max()) for v in truth.values())
    out = {}
    for name, g in grads.items():
        norm = float(np.sqrt(sum(float((np.asarray(v, np.float64) ** 2).sum())
                                 for v in g.values())))
        dev = max(float(np.abs(np.asarray(g[k], np.float64) - truth[k]).max())
                  for k in truth)
        out[name] = dict(global_norm=norm, max_dev_rel=dev / scale)
    return dict(largest_entry=scale, **out)


def stage_chain() -> dict:
    """conv + BatchNorm + ReLU x 3, then max over the neighbours, with the
    first SA stage's weights on random input (6, 16, 8, 3): the directional
    derivative along a random direction of the weights, four ways."""
    _, jvars, _ = train_models(jax_dtype=np.float64)
    params = jvars["params"]["backbone"]["sa_0"]
    stats = jvars["batch_stats"]["backbone"]["sa_0"]
    names = ("mlp_0", "mlp_1", "mlp_2")
    params = {k: params[k] for k in names}
    rs = np.random.RandomState(0)
    blk = ConvBNReLU(32, dtype=jnp.float64)
    x = jnp.asarray(rs.randn(6, 16, 8, 3))
    cot = {"max": jnp.asarray(rs.randn(6, 16, 32)),
           "sum": jnp.asarray(rs.randn(6, 16, 8, 32))}
    direction = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.randn(*a.shape)), params)

    def along(g) -> float:
        return float(sum(jnp.sum(a * b) for a, b in zip(
            jax.tree_util.tree_leaves(g),
            jax.tree_util.tree_leaves(direction))))

    out = {}
    for end in ("max", "sum"):
        def f(p):
            h = x
            for name in names:
                h, _ = blk.apply({"params": p[name],
                                  "batch_stats": stats[name]}, h, True,
                                 mutable=["batch_stats"])
            if end == "max":
                h = jnp.max(h, axis=2)
            return jnp.sum(h * cot[end])

        eps = 1e-6
        shift = lambda s: jax.tree_util.tree_map(  # noqa: E731
            lambda a, d: a + s * d, params, direction)
        out[end] = dict(
            finite_difference=float(f(shift(eps)) - f(shift(-eps)))
            / (2 * eps),
            op_by_op=along(jax.grad(f)(params)),
            jit=along(jax.jit(jax.grad(f))(params)),
            jit_no_algsimp=along(compiled(jax.grad(f), params)))
    return out


def main():
    with jax.enable_x64():
        versions = dict(jax=jax.__version__, torch=torch.__version__)
        print(json.dumps(dict(**versions, **model_gradients())))
        print(json.dumps(dict(stage_chain=stage_chain())))


if __name__ == "__main__":
    main()
