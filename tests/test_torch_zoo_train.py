"""Training the tracker-era zoo against the JAX package: one train step of
the 'xcorr' head with every kernel knob on (kNN 'pallas', the cross and
local stages 'linear-pallas': the attention kernel's plain version under
autograd at one query a row) against JAX's compiled step; for the other
zoo configs the gradients of match_logits with respect to the match
stages' and head's parameters and to both sides' features, against
jax.grad; VN-DGCNN's train-mode backbone gradients and statistics.

Tolerances: the step as tests/_torch_port.check_leaf_step (the port's logs
in float64 against JAX's float64 step at 1e-6, in float32 at 1e-3);
gradients in float64 on both sides at 1e-9 of each tensor's scale (floor
1e-3 of the largest entry, tests/_torch_port.assert_grads_close).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests._torch_port import (NO_ALGSIMP, assert_close_scaled,  # noqa: E402
                               assert_grads_close, check_leaf_step, port_flat)
from tests._torch_zoo import N_PTS, dup_crops, zoo_cfgs, zoo_models  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

GRAD64_TOL = 1e-9
KNOBS = ["model.knn_method=pallas",
         "model.cross_stage1.attention=linear-pallas",
         "model.cross_stage2.attention=linear-pallas",
         "model.local_stage1.attention=linear-pallas",
         "model.local_stage2.attention=linear-pallas"]


def test_xcorr_train_step_with_the_knobs_matches_jax():
    """The 'xcorr' head's step with kNN and every attention stage on the
    kernels (their plain versions here; JAX's in interpret mode): the logs
    (the weights after the step are not compared: JAX's attention kernel
    computes in float32 at every dtype, check_leaf_step says why)."""
    cfg, _ = zoo_cfgs("xcorr", KNOBS)
    assert cfg["local_stage2"]["attention"] == "linear-pallas"
    check_leaf_step(cfg, weights=False)


@pytest.mark.parametrize("name", ["cosine", "loftr", "loftr-linear",
                                  "vn_dgcnn", "add", "minus", "cat", "max"])
def test_match_logits_gradients_match_jax(name):
    """d sum(match_logits * cot) by the match stages' and head's
    parameters (none for ReIDNetCosine) and by both sides' (B, N, d)
    features, train mode, in float64 on both sides."""
    rs = np.random.RandomState(7)
    B = 4
    h1, h2 = (rs.randn(B, N_PTS, 64) for _ in range(2))
    x1, x2 = ((rs.randn(B, N_PTS, 3) * 0.6) for _ in range(2))
    cot = rs.randn(B)
    with jax.enable_x64():
        jmodel, jvars, tmodel = zoo_models(name, "float64")

        def jloss(params, h1, h2):
            logits, _ = jmodel.apply(
                {"params": params, "batch_stats": jvars["batch_stats"]},
                h1, x1, h2, x2, train=True, method="match_logits")
            return jnp.sum(logits * cot), logits
        (_, jlogits), (jg, jdh1, jdh2) = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.value_and_grad(
                jloss, argnums=(0, 1, 2), has_aux=True))(
                jvars["params"], jnp.asarray(h1), jnp.asarray(h2)))
    th1, th2 = (torch.from_numpy(a).requires_grad_(True) for a in (h1, h2))
    tmodel.requires_grad_(True)
    tmodel.zero_grad()
    try:
        logits, _ = tmodel.match_logits(th1, torch.from_numpy(x1), th2,
                                        torch.from_numpy(x2), train=True)
        (logits * torch.from_numpy(cot)).sum().backward()
        got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()
               if p.grad is not None}
    finally:
        tmodel.requires_grad_(False)
    assert_close_scaled(logits.detach().numpy(), jlogits, GRAD64_TOL,
                        "logits")
    want = {k: v for k, v in port_flat(jg).items()
            if not k.startswith(("backbone.", "downsample."))}
    assert set(got) == set(want)
    assert (not want) == (name == "cosine")
    if want:
        assert_grads_close(got, want, GRAD64_TOL)
    assert_grads_close({"h1": th1.grad.numpy(), "h2": th2.grad.numpy()},
                       {"h1": jdh1, "h2": jdh2}, GRAD64_TOL)


def test_vn_dgcnn_train_mode_embed_matches_jax():
    """VN-DGCNN + downsample in train mode on crops with duplicated
    points: the embedding, every parameter's gradient and the running
    statistics every BatchNorm moved to, float64 on both sides (JAX's step
    compiled with the algebraic simplifier off, as tests/_torch_port's
    train steps)."""
    x = dup_crops(9, B=3)
    rs = np.random.RandomState(10)
    cot = rs.randn(3, N_PTS, 64)
    with jax.enable_x64():
        jmodel, jvars, tmodel = zoo_models("vn_dgcnn", "float64")

        def jloss(params, x):
            (_, h), mut = jmodel.apply(
                {"params": params, "batch_stats": jvars["batch_stats"]},
                x, train=True, method="embed", mutable=["batch_stats"])
            return jnp.sum(h * cot), (h, mut["batch_stats"])
        params = {k: v for k, v in jvars["params"].items()
                  if k in ("backbone", "downsample")}
        fn = jax.value_and_grad(jloss, has_aux=True)
        xj = jnp.asarray(x, jnp.float64)
        compiled = jax.jit(fn).lower(params, xj).compile(
            compiler_options=NO_ALGSIMP)
        (_, (jh, jstats)), jg = jax.tree_util.tree_map(
            np.asarray, compiled(params, xj))
    model = copy.deepcopy(tmodel).requires_grad_(True)
    _, th = model.embed(torch.from_numpy(x).double(), train=True)
    (th * torch.from_numpy(cot)).sum().backward()
    assert_close_scaled(th.detach().numpy(), jh, GRAD64_TOL, "embed")
    # the directional max pools' map_to_dir only picks (an argmax): no
    # gradient reaches it, which JAX reports as zeros
    got = {k: np.zeros(tuple(p.shape)) if p.grad is None else p.grad.numpy()
           for k, p in model.named_parameters()
           if k.startswith(("backbone.", "downsample."))}
    want = port_flat(jg)
    assert not any(want[k].any() for k in got if ".pool" in k)
    assert_grads_close(got, want, GRAD64_TOL)
    want = port_flat(jstats)
    stats = {k: v.numpy() for k, v in model.state_dict().items()
             if "running_" in k}
    assert set(stats) == set(want) and len(stats) == 14
    for k, v in want.items():
        assert_close_scaled(stats[k], v, GRAD64_TOL, k)
