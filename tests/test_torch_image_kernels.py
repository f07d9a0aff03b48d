"""The plain versions of the image match kernels (the chain without any
position term, over the true token count) against the JAX package's Pallas
image grid and pair scorers run in interpret mode, and against the port's
own hoisted grid. CPU, float32, one set of weights on both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops.pallas.match_grid import (  # noqa: E402
    pallas_image_grid_logits, pallas_image_pair_logits)
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from tests._torch_image import tiny_image_models, tokens  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

# the JAX suite's own bar for the kernel against the XLA path
# (tests/test_pair_grid.py)
RTOL, ATOL = 2e-4, 2e-5


# S=6 is the tiny DeiT's token count, 16 is a multiple of Mosaic's 8-row
# tile, 11 is not: there the TPU kernel pads and masks, the port does not
@pytest.mark.parametrize("S", [6, 16, 11])
def test_plain_image_grid_and_pairs_match_pallas_interpret(S):
    jmodel, jvars, tmodel = tiny_image_models()
    nt, nd = 3, 8
    h_t, h_d = tokens(10 + S, nt, S), tokens(20 + S, nd, S)
    want = np.asarray(pallas_image_grid_logits(
        jmodel, jvars, jnp.asarray(h_t), jnp.asarray(h_d), det_block=4,
        interpret=True))
    with torch.no_grad():
        got = mg.image_grid_logits(tmodel, torch.from_numpy(h_t),
                                   torch.from_numpy(h_d))
        hoisted = tmodel.match_logits_grid(torch.from_numpy(h_t),
                                           torch.from_numpy(h_d))
    assert got.shape == (nt, nd)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), hoisted.numpy(), rtol=RTOL,
                               atol=ATOL)

    rs = np.random.RandomState(S)
    t_idx = rs.randint(0, nt, 8).astype(np.int32)
    d_idx = rs.randint(0, nd, 8).astype(np.int32)
    want_p = np.asarray(pallas_image_pair_logits(
        jmodel, jvars, jnp.asarray(h_t), jnp.asarray(h_d),
        jnp.asarray(t_idx), jnp.asarray(d_idx), pair_block=4,
        interpret=True))
    with torch.no_grad():
        got_p = mg.image_pair_logits(tmodel, torch.from_numpy(h_t),
                                     torch.from_numpy(h_d),
                                     torch.from_numpy(t_idx),
                                     torch.from_numpy(d_idx))
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=RTOL, atol=ATOL)
    # the pair list is the grid at the same indices
    np.testing.assert_allclose(got_p.numpy(), got.numpy()[t_idx, d_idx],
                               rtol=1e-6, atol=1e-6)


def test_image_factors_and_wrapper_checks():
    """image_grid_factors' shapes; a side of the wrong number of tensors
    and out-of-range pairs raise; a head the kernel does not compute is
    scored by the model's own path."""
    _, _, tmodel = tiny_image_models()
    h = torch.from_numpy(tokens(1, 3, 6))
    with torch.no_grad():
        t, d, w1, w2, nhead = mg.image_match_factors(tmodel, h, h)
        point_like = t + (t[0],)
    assert [tuple(x.shape) for x in t] == [(3, 6, 16), (3, 6, 16),
                                           (3, 16, 32), (3, 6, 32)]
    with pytest.raises(ValueError, match="4 tensors"):
        mg.fused_image_match_grid(point_like, point_like, w1, w2, nhead)
    with pytest.raises(ValueError, match="5 tensors"):
        mg.fused_match_grid(t, d, w1, w2, nhead)
    with pytest.raises(ValueError):
        mg.match_pooled_reference(t, point_like, w1, w2, nhead,
                                  torch.zeros(1, dtype=torch.long),
                                  torch.zeros(1, dtype=torch.long))
    with pytest.raises(IndexError, match="out of range"):
        mg.fused_image_match_pairs(t, d, w1, w2, nhead, torch.tensor([3]),
                                   torch.tensor([0]))
    assert mg.fused_image_match_grid.launches == 0
    assert mg.fused_image_match_pairs.launches == 0

    # a head the kernel does not compute is scored by the model's own path
    # (JAX's match_logits_grid / xla_image_pair_logits) and launches nothing
    import copy
    other = copy.deepcopy(tmodel)
    other.combine = "add"
    assert not PairScorer(other, image_mode=True).fused
    with torch.no_grad():
        got = mg.image_grid_logits(other, h, h)
        assert torch.equal(got, other.match_logits_grid(h, h))
        ti, di = torch.tensor([0, 2, 1]), torch.tensor([1, 2, 0])
        pairs = mg.image_pair_logits(other, h, h, ti, di)
    torch.testing.assert_close(pairs, got[ti, di], rtol=1e-5, atol=1e-6)
    assert mg.fused_image_match_grid.launches == 0
    from tests._torch_port import tiny_torch_model
    with pytest.raises(TypeError, match="ImageReIDNet"):
        PairScorer(tiny_torch_model(), image_mode=True)


def test_image_cost_matrix_pads_and_gates():
    """PairScorer(image_mode).cost_matrix: padded to buckets, -inf exactly
    where the classes differ, the hoisted grid elsewhere."""
    _, _, tmodel = tiny_image_models()
    scorer = PairScorer(tmodel, image_mode=True)
    h_t, h_d = (torch.from_numpy(tokens(31, 3, 6)),
                torch.from_numpy(tokens(32, 5, 6)))
    got = scorer.cost_matrix(h_t, None, h_d, None, np.array([0, 1, 0]),
                             np.array([0, 0, 1, 1, 0])).numpy()
    with torch.no_grad():
        want = tmodel.match_logits_grid(h_t, h_d).numpy()
    ok = np.array([0, 1, 0])[:, None] == np.array([0, 0, 1, 1, 0])[None]
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(np.isinf(got), ~ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)
