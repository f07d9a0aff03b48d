"""The port's reference-checkpoint loader (convert/torch_checkpoint.py)
against the JAX package's converter: the same reference-named state dicts,
made by the JAX suite's torch replicas (the flagship, PointNet, DGCNN and
the image model), loaded by the port and by convert_*_state_dict followed
by from_jax_variables, give the same port state dict bit for bit and the
same reports; strict mode raises where the JAX converter raises."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.convert import torch_checkpoint as jconv  # noqa: E402
from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.models.dgcnn import (  # noqa: E402
    DGCNNBackbone as JDGCNN)
from point_cloud_reid_tpu.models.pointnet import (  # noqa: E402
    PointNetBackbone as JPointNet)
from point_cloud_reid_tpu_torch.configs import (  # noqa: E402
    point_transformer_point_cat)
from point_cloud_reid_tpu_torch.convert import (  # noqa: E402
    from_jax_variables, load_image_reference_state_dict,
    load_reference_state_dict, load_torch_state_dict)
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.models.dgcnn import DGCNNBackbone  # noqa: E402
from point_cloud_reid_tpu_torch.models.pointnet import (  # noqa: E402
    PointNetBackbone)
from tests._torch_image import tiny_image_cfg  # noqa: E402
from tests._torch_port import TINY  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401
from tests.test_convert_backbones import (TorchDGCNN,  # noqa: E402
                                          TorchPointNet)
from tests.test_convert_full_model import TorchReIDNet  # noqa: E402
from tests.test_convert_image_model import TorchImageReIDNet  # noqa: E402
from tests.test_convert_vit import _tiny_deit_config  # noqa: E402


def _randomise_bn_stats(module, seed):
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=g))
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=g) + 0.5)


def _template(init, *args):
    """A flax init's variables as zeros of their shapes: the tree traced by
    jax.eval_shape, without running the init op by op."""
    shapes = jax.eval_shape(lambda *a: init(jax.random.PRNGKey(0), *a,
                                            train=False), *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def _numpy_sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _same_report(port, jax_report):
    assert port["unmatched_torch"] == jax_report["unmatched_torch"]
    assert sorted(port["unfilled_flax"]) == sorted(jax_report["unfilled_flax"])


# ---- the flagship -----------------------------------------------------------

def _flagship():
    """(replica state dict with the dead FP keys, port model, config, JAX
    template variables, replica, example inputs)."""
    torch.manual_seed(7)
    replica = TorchReIDNet(conv_out=16).eval()
    _randomise_bn_stats(replica, 1)
    sd = _numpy_sd(replica)
    rs = np.random.RandomState(2)
    for i, c in ((0, 32), (1, 64), (2, 128)):     # built, never run
        sd[f"backbone.FP_modules.{i}.mlp_convs.0.weight"] = rs.randn(c, c, 1)
        sd[f"backbone.FP_modules.{i}.mlp_bns.0.running_mean"] = rs.randn(c)
    cfg = point_transformer_point_cat(**TINY)
    B, N = 2, 32
    s1 = rs.randn(B, N, 3).astype(np.float32)
    s2 = rs.randn(B, N, 3).astype(np.float32)
    jmodel = jax_build(cfg)
    batch = dict(sparse_1=jnp.asarray(s1), sparse_2=jnp.asarray(s2),
                 id_1=jnp.zeros((B,), jnp.int32),
                 id_2=jnp.zeros((B,), jnp.int32))
    jvars = _template(jmodel.init, batch)
    port = build_model(cfg, generator=torch.Generator().manual_seed(3))
    return sd, port, cfg, jvars, replica, (s1, s2)


def test_flagship_loader_equals_the_jax_route_bit_for_bit(tmp_path):
    sd, port, cfg, jvars, replica, (s1, s2) = _flagship()
    # the released file's form: mmcv envelope, DDP prefixes
    path = tmp_path / "ref.pth"
    torch.save({"meta": {"epoch": 500}, "state_dict": {
        "module." + k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}},
        path)
    loaded = load_torch_state_dict(str(path))
    want_sd = jconv.load_torch_state_dict(str(path))
    assert loaded.keys() == want_sd.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(loaded[k], want_sd[k])

    report = load_reference_state_dict(port, loaded)
    jnew, jreport = jconv.convert_reidnet_state_dict(loaded, jvars)
    via_jax = from_jax_variables(
        build_model(cfg, generator=torch.Generator().manual_seed(4)),
        _np_tree(jnew))
    _assert_same_state(port, via_jax)
    _same_report(report, jreport)
    assert report == {"unmatched_torch": [], "unfilled_flax": []}
    # and the loaded port model computes the replica's logits
    with torch.no_grad():
        want = replica(torch.from_numpy(s1), torch.from_numpy(s2),
                       list(TINY["backbone_list"])).numpy()
        got = port(dict(sparse_1=torch.from_numpy(s1),
                        sparse_2=torch.from_numpy(s2)))["match_logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_strict_raises_where_jax_raises_and_reports_agree():
    sd, port, cfg, jvars, _, _ = _flagship()
    extra = dict(sd, **{"cross_stage1.mystery.weight": np.ones((4, 4),
                                                                np.float32)})
    missing = {k: v for k, v in sd.items()
               if not k.startswith("match_head.1.")}
    bad_shape = dict(sd, **{"match_head.1.weight": np.ones((1, 7),
                                                           np.float32)})
    for case in (extra, missing, bad_shape):
        with pytest.raises(ValueError):
            jconv.convert_reidnet_state_dict(case, jvars, strict=True)
        before = {k: v.clone() for k, v in port.state_dict().items()}
        with pytest.raises(ValueError, match="conversion mismatch"):
            load_reference_state_dict(port, case, strict=True)
        for k, v in port.state_dict().items():        # nothing written
            assert torch.equal(v, before[k]), k
        _, jreport = jconv.convert_reidnet_state_dict(case, jvars,
                                                      strict=False)
        report = load_reference_state_dict(port, case, strict=False)
        _same_report(report, jreport)
        assert report["unmatched_torch"] or report["unfilled_flax"]


# ---- PointNet and DGCNN -----------------------------------------------------

def _backbone_case(family):
    if family == "pointnet":
        torch.manual_seed(0)
        replica = torch.nn.Module()
        replica.backbone = TorchPointNet()
        jmod = JPointNet(channel=3, name="backbone")
        port = torch.nn.Module()
        port.backbone = PointNetBackbone(channel=3)
        n = 24
    else:
        torch.manual_seed(1)
        replica = torch.nn.Module()
        replica.backbone = TorchDGCNN(emb_dims=64, k=6)
        jmod = JDGCNN(emb_dims=64, k=6, name="backbone")
        port = torch.nn.Module()
        port.backbone = DGCNNBackbone(emb_dims=64, k=6)
        n = 20
    _randomise_bn_stats(replica, 5)

    class Wrap(fnn.Module):
        @fnn.compact
        def __call__(self, pts, train=False):
            return jmod.clone(parent=self)(pts, train=train)

    pts = np.random.RandomState(0).randn(2, n, 3).astype(np.float32)
    jvars = _template(Wrap().init, jnp.asarray(pts))
    return replica.eval(), port.eval(), jvars


@pytest.mark.parametrize("family", ["pointnet", "dgcnn"])
def test_backbone_families_equal_the_jax_route(family):
    replica, port, jvars = _backbone_case(family)
    sd = _numpy_sd(replica)
    if family == "dgcnn":     # the bn copies Sequential re-registers
        assert any(k.startswith("backbone.conv1.1.") for k in sd)
    report = load_reference_state_dict(port, sd)
    jnew, jreport = jconv.convert_reidnet_state_dict(sd, jvars)
    _, fresh, _ = _backbone_case(family)
    via_jax = from_jax_variables(fresh, _np_tree(jnew))
    _assert_same_state(port, via_jax)
    _same_report(report, jreport)


# ---- the image model --------------------------------------------------------

def _image_case():
    from transformers import DeiTModel
    torch.manual_seed(0)
    hf = DeiTModel(_tiny_deit_config(image_size=32))
    replica = TorchImageReIDNet(hf, dim=32, ds=16).eval()
    cfg = tiny_image_cfg("deit-test", aux=False)
    sd = {}
    for k, v in _numpy_sd(replica).items():
        # the distilled checkpoint's level, with the teacher's heads
        sd[k.replace("backbone.", "backbone.deit.", 1)] = v
    rs = np.random.RandomState(3)
    sd["backbone.cls_classifier.weight"] = rs.randn(10, 32)
    sd["backbone.distillation_classifier.bias"] = rs.randn(10)
    im = rs.randn(2, 3, 32, 32).astype(np.float32)
    jmodel = jax_build(cfg)
    batch = dict(sparse_1=jnp.asarray(im), sparse_2=jnp.asarray(im),
                 id_1=jnp.zeros((2,), jnp.int32),
                 id_2=jnp.zeros((2,), jnp.int32))
    jvars = _template(jmodel.init, batch)
    return sd, cfg, jvars, replica, im


def test_image_loader_equals_the_jax_route_bit_for_bit():
    sd, cfg, jvars, replica, im = _image_case()
    assert any(k.startswith("cross_stage1.pos_mlp.") for k in sd)  # dead
    port = build_model(cfg, generator=torch.Generator().manual_seed(3))
    report = load_image_reference_state_dict(port, sd)
    jnew, jreport = jconv.convert_image_reidnet_state_dict(sd, jvars)
    via_jax = from_jax_variables(
        build_model(cfg, generator=torch.Generator().manual_seed(4)),
        _np_tree(jnew))
    _assert_same_state(port, via_jax)
    _same_report(report, jreport)
    im2 = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = replica(torch.from_numpy(im), torch.from_numpy(im2)).numpy()
        got = port(dict(sparse_1=torch.from_numpy(im),
                        sparse_2=torch.from_numpy(im2)))["match_logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_image_loader_strict_cases():
    sd, cfg, jvars, _, _ = _image_case()
    port = build_model(cfg, generator=torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    extra_bb = dict(sd, **{"backbone.deit.encoder.layer.0.mystery.weight":
                           np.ones(2, np.float32)})
    missing = {k: v for k, v in sd.items()
               if not k.startswith("match_head.1.")}
    for case in (extra_bb, missing):
        with pytest.raises(ValueError):
            jconv.convert_image_reidnet_state_dict(case, jvars, strict=True)
        with pytest.raises(ValueError, match="image checkpoint"):
            load_image_reference_state_dict(port, case, strict=True)
        for k, v in port.state_dict().items():
            assert torch.equal(v, before[k]), k
        _, jreport = jconv.convert_image_reidnet_state_dict(case, jvars,
                                                            strict=False)
        probe = build_model(cfg, generator=torch.Generator().manual_seed(3))
        _same_report(load_image_reference_state_dict(probe, case,
                                                     strict=False), jreport)


# ---- reference_state_dict: the writer a dry run uses ------------------------

FAMILIES = ["pts_point-transformer_point-cat_nus_det_4x256_500e",
            "pts_pointnet_point-cat_nus_det_4x256_500e",
            "pts_dgcnn_point-cat_nus_det_4x256_500e",
            "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"]


def _family_cfg(name):
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.configs.zoo import ZOO
    if name in ZOO:
        leaf, sets = ZOO[name]
        return get_experiment(leaf, set_options=sets)["model"]
    if name in ("deit-test", "beit-test"):
        return tiny_image_cfg(name)
    return get_experiment(name)["model"]


@pytest.mark.parametrize("name", FAMILIES + ["vn_dgcnn", "xcorr", "cosine",
                                             "loftr", "cat", "beit-test"])
def test_reference_state_dict_round_trips_every_family(name):
    """A port model written under the reference's names and layouts
    (convert.reference_state_dict) loads back into a differently seeded
    model bit for bit, strictly: every registered backbone family, the
    zoo's VN-DGCNN and heads, and the image models (DeiT and BEiT ViTs
    under HF names)."""
    from point_cloud_reid_tpu_torch.convert import reference_state_dict
    cfg = _family_cfg(name)
    a = build_model(cfg, generator=torch.Generator().manual_seed(1))
    _randomise_bn_stats(a, 2)
    b = build_model(cfg, generator=torch.Generator().manual_seed(2))
    sd = {k: v.numpy() for k, v in reference_state_dict(a).items()}
    if "pts_point-transformer" in name:
        assert sd["backbone.SA_modules.0.mlp_convs.0.weight"].ndim == 4
        assert sd["backbone.cov_final.weight"].ndim == 3
    if name.startswith("pts_dgcnn"):
        assert "backbone.conv1.1.running_mean" in sd
    image = cfg.get("type") == "ImageReIDNet"
    load = load_image_reference_state_dict if image \
        else load_reference_state_dict
    report = load(b, sd)
    assert report == {"unmatched_torch": [], "unfilled_flax": []}
    _assert_same_state(a, b)
