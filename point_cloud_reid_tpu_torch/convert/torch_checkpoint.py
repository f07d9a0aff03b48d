"""Load reference PyTorch ReIDNet checkpoints (.pth) into the port's models,
the port of point_cloud_reid_tpu/convert/torch_checkpoint.py.

A released checkpoint names its tensors after the reference's modules
(backbone.SA_modules.{i}.mlp_convs.{j}, cross_stage{1,2}.*, match_head.{j},
the PointNet and DGCNN trunks, ...). The JAX converter rewrites those names
onto a flax tree; the port's modules keep the reference's names, and
convert.jax_variables moves weights between a flax tree and a port model.
So a load here runs the JAX converter's own rules (copied below: its name
rewrites, skip lists, layout changes, report and strictness) against the
flax-layout view of the port model (to_jax_variables), then writes the
result into the model (from_jax_variables). A load therefore gives, bit
for bit, the weights that the JAX converter followed by from_jax_variables
gives, and the same report (one rule more here: a LoFTR head's layer keys,
which the JAX converter leaves unmatched): 'unmatched_torch' (checkpoint keys that found
no target, or a target of another shape) and 'unfilled_flax' (targets no
key filled; they keep the model's values).

Skipped as in the JAX converter: BatchNorm's num_batches_tracked, the FP
modules' mlp_convs / mlp_bns (built by the reference, never run), DGCNN's
re-registered backbone.conv\\d.1. BatchNorm copies, and for the image model
the cross stages' unused pos_mlp. The image model's ViT loads through
convert.hf_vit (the backbone.deit. level and the teacher's classifier and
pooler keys dropped).

reference_state_dict is the inverse of the loaders: a port model's weights
under the reference's names and layouts (what a dry run of the path writes
in place of a released file; the keys the reference builds but never runs
are not in the port and not written).

Nothing here imports jax: the flax-layout view is a dict of numpy arrays.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .hf_vit import convert_hf_vit_state_dict, hf_vit_state_dict
from .jax_variables import from_jax_variables, to_jax_variables


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference .pth checkpoint as a flat {name: ndarray} dict: mmcv's
    {'state_dict': ...} envelope unwrapped and DDP's 'module.' prefixes
    stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
    return out


# whole-key rewrites before the leaf rules (PointNet STN / trunk, DGCNN
# blocks: the reference's standalone bnN attributes pair with convN / fcN)
_PREFIX_RULES: List[Tuple[str, str]] = [
    (r"\.(stn|fstn)\.conv(\d)\.", r".\1.conv\2.conv."),
    (r"\.(stn|fstn)\.bn([123])\.", r".\1.conv\2.bn."),
    (r"\.(stn|fstn)\.bn4\.", r".\1.fc1.bn."),
    (r"\.(stn|fstn)\.bn5\.", r".\1.fc2.bn."),
    (r"\.(stn|fstn)\.fc([12])\.", r".\1.fc\2.conv."),
    (r"\.feat\.conv([12])\.", r".feat.conv\1.conv."),
    (r"\.feat\.bn([12])\.", r".feat.conv\1.bn."),
    (r"^backbone\.conv([1-4])\.0\.", r"backbone.conv\1.conv."),
    (r"^backbone\.bn([1-4])\.", r"backbone.conv\1.bn."),
    (r"^backbone\.conv5\.0\.", r"backbone.conv5."),
]

# suffix rewrites within a module (ordered; the first match wins)
_LEAF_RULES: List[Tuple[str, str]] = [
    (r"pos_mlp\.0\.(weight|bias)$", r"pos_mlp/fc1/\1"),
    (r"pos_mlp\.2\.(weight|bias)$", r"pos_mlp/fc2/\1"),
    (r"pos_mlp2\.0\.(weight|bias)$", r"pos_mlp2/fc1/\1"),
    (r"pos_mlp2\.2\.(weight|bias)$", r"pos_mlp2/fc2/\1"),
    (r"pos_mlp_knn\.0\.(weight|bias)$", r"pos_mlp_knn/fc1/\1"),
    (r"pos_mlp_knn\.2\.(weight|bias)$", r"pos_mlp_knn/fc2/\1"),
    (r"mlp\.0\.(weight|bias)$", r"mlp_fc1/\1"),
    (r"mlp\.2\.(weight|bias)$", r"mlp_fc2/\1"),
    (r"mlp_knn\.0\.(weight|bias)$", r"mlp_knn_fc1/\1"),
    (r"mlp_knn\.2\.(weight|bias)$", r"mlp_knn_fc2/\1"),
    (r"mlp_convs\.(\d+)\.(weight|bias)$", r"mlp_\1/conv/\2"),
    (r"mlp_bns\.(\d+)\.(weight|bias|running_mean|running_var)$",
     r"mlp_\1/bn/\2"),
    (r"transform\.0\.(weight|bias)$", r"transform_linear/\1"),
    (r"transform\.1\.(weight|bias|running_mean|running_var)$",
     r"transform_norm/\1"),
]

# LoFTR cross stages (the zoo's loftr heads): flax names a layer layers_{i}
# and its FFN mlp_0 / mlp_2. The JAX converter has no such rule and leaves
# these keys unmatched; the port's loader maps them.
_LOFTR_RULES: List[Tuple[str, str]] = [
    (r"(^|\.)loftr\.layers\.(\d+)\.mlp\.([02])\.",
     r"\1loftr.layers_\2.mlp_\3."),
    (r"(^|\.)loftr\.layers\.(\d+)\.", r"\1loftr.layers_\2."),
]

_HEAD_NAMES = ("match_head", "cls_head", "fp_head", "shape_head",
               "downsample", "vis_head")

SKIP_PATTERNS = [
    r"num_batches_tracked$",
    r"^backbone\.FP_modules\.\d+\.mlp_convs\.",   # built, never run
    r"^backbone\.FP_modules\.\d+\.mlp_bns\.",
    r"^backbone\.conv\d\.1\.",                    # DGCNN's bn re-registered
]

# the image model's cross stages build a pos_mlp their forward never uses
IMAGE_SKIP_PATTERNS = [r"^(cross_stage\d|local_stage\d)\.pos_mlp\."]


def _translate(tkey: str, head_children: Dict[str, List[str]]) -> str:
    """Reference dotted name -> collection-relative flax slash path."""
    k = tkey
    for pat, rep in _LOFTR_RULES:
        k = re.sub(pat, rep, k)
    k = re.sub(r"^backbone\.SA_modules\.(\d+)\.", r"backbone.sa_\1.", k)
    k = re.sub(r"^backbone\.FP_modules\.(\d+)\.interpolation\.",
               r"backbone.fp_\1.interpolation.", k)
    for pat, rep in _PREFIX_RULES:
        if re.search(pat, k):
            k = re.sub(pat, rep, k)
            break
    m = re.match(r"^(%s)\.(\d+)\.(.*)$" % "|".join(_HEAD_NAMES), k)
    if m:
        head, idx, rest = m.groups()
        child = next((c for c in head_children.get(head, [])
                      if c.split("_", 1)[0] == idx), idx)
        k = f"{head}.{child}.{rest}"
    for pat, rep in _LEAF_RULES:
        if re.search(pat, k):
            k = re.sub(pat, rep, k)
            break
    return k.replace(".", "/")


def _transform_value(v: np.ndarray, leaf: str) -> np.ndarray:
    """The reference tensor's layout -> the flax leaf's."""
    if leaf == "kernel":
        if v.ndim == 2:                      # Linear (out, in) -> (in, out)
            return v.T
        if v.ndim == 3:                      # Conv1d (out, in, k)
            return v[:, :, 0].T if v.shape[-1] == 1 else v.transpose(2, 1, 0)
        if v.ndim == 4:                      # Conv2d (out, in, kh, kw)
            if v.shape[-1] == 1 and v.shape[-2] == 1:
                return v[:, :, 0, 0].T
            return v.transpose(2, 3, 1, 0)
    return v


def _leaf_rename(path: str) -> Tuple[str, str]:
    if path.endswith("/running_mean"):
        return "batch_stats", path.replace("/running_mean", "/mean")
    if path.endswith("/running_var"):
        return "batch_stats", path.replace("/running_var", "/var")
    return "params", path


def _tree_paths(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _set_path(tree: Dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def convert_reidnet_state_dict(state_dict: Dict[str, np.ndarray],
                               variables: Dict[str, Any],
                               strict: bool = True,
                               extra_skip_patterns: Tuple[str, ...] = ()
                               ) -> Tuple[Dict[str, Any],
                                          Dict[str, List[str]]]:
    """The JAX converter on a flax-layout tree of numpy arrays: (the tree
    filled from the reference state dict, report). strict raises
    ValueError if a non-skipped key finds no target or a target stays
    unfilled."""
    new_vars = _copy_tree(variables)
    template = {c: _tree_paths(t) for c, t in variables.items()}
    params = template.get("params", {})

    def flaxify_leaf(path: str) -> str:
        head, _, leaf = path.rpartition("/")
        if leaf == "weight":
            for cand in (head + "/kernel", head + "/scale"):
                if cand in params:
                    return cand
            return head + "/kernel"
        return path

    head_children = {h: list(sub.keys()) for h in _HEAD_NAMES
                     if isinstance(sub := variables.get("params", {}).get(h),
                                   dict)}
    report: Dict[str, List[str]] = {"unmatched_torch": [],
                                    "unfilled_flax": []}
    filled = {c: set() for c in template}
    skip = list(SKIP_PATTERNS) + list(extra_skip_patterns)
    for tkey, tval in state_dict.items():
        if any(re.search(p, tkey) for p in skip):
            continue
        collection, path = _leaf_rename(_translate(tkey, head_children))
        if collection == "params":
            path = flaxify_leaf(path)
            if path.endswith("/weight"):
                path = path[: -len("weight")] + "scale"
        if collection not in template or path not in template[collection]:
            report["unmatched_torch"].append(f"{tkey} -> {collection}:{path}")
            continue
        val = _transform_value(np.asarray(tval), path.rsplit("/", 1)[-1])
        want = np.asarray(template[collection][path])
        if tuple(val.shape) != tuple(want.shape):
            report["unmatched_torch"].append(
                f"{tkey} -> {collection}:{path} shape {val.shape} != "
                f"{want.shape}")
            continue
        _set_path(new_vars[collection], path, val.astype(want.dtype))
        filled[collection].add(path)
    for c, paths in template.items():
        report["unfilled_flax"] += [f"{c}:{p}" for p in paths
                                    if p not in filled[c]]
    if strict and (report["unmatched_torch"] or report["unfilled_flax"]):
        raise ValueError(
            "checkpoint conversion mismatch:\n  unmatched torch keys:\n    "
            + "\n    ".join(report["unmatched_torch"][:20])
            + "\n  unfilled flax leaves:\n    "
            + "\n    ".join(report["unfilled_flax"][:20]))
    return new_vars, report


def load_reference_state_dict(model: torch.nn.Module,
                              sd: Dict[str, np.ndarray], strict: bool = True,
                              extra_skip_patterns: Tuple[str, ...] = ()
                              ) -> Dict[str, List[str]]:
    """Load a reference state dict (load_torch_state_dict's) into a port
    ReIDNet of any registered backbone family, in place. Returns the JAX
    converter's report; strict raises where it raises."""
    new_vars, report = convert_reidnet_state_dict(
        sd, to_jax_variables(model), strict=strict,
        extra_skip_patterns=extra_skip_patterns)
    from_jax_variables(model, new_vars)
    return report


def load_image_reference_state_dict(model: torch.nn.Module,
                                    sd: Dict[str, np.ndarray],
                                    strict: bool = True
                                    ) -> Dict[str, List[str]]:
    """Load a reference ImageReIDNet state dict into a port ImageReIDNet in
    place: the HF ViT under 'backbone.' (or 'backbone.deit.', the
    distilled DeiT's level; its classifiers and pooler dropped) through
    convert.hf_vit, the rest as load_reference_state_dict with the cross
    stages' dead pos_mlp skipped. As in the JAX converter the report lists
    the backbone's unmatched keys but not its unfilled tensors."""
    backbone_sd, rest_sd = {}, {}
    for k, v in sd.items():
        if not k.startswith("backbone."):
            rest_sd[k] = v
            continue
        kk = k[len("backbone."):]
        if kk.startswith("deit."):
            kk = kk[len("deit."):]
        if kk.startswith(("cls_classifier", "distillation_classifier",
                          "pooler.")):
            continue
        backbone_sd[kk] = v
    # into a copy, so that a strict failure leaves the model as it was
    backbone = copy.deepcopy(model.backbone)
    unmatched_bb = convert_hf_vit_state_dict(backbone_sd, backbone)
    variables = to_jax_variables(model)
    rest_vars = {c: ({k: v for k, v in t.items() if k != "backbone"}
                     if c == "params" else t) for c, t in variables.items()}
    new_vars, report = convert_reidnet_state_dict(
        rest_sd, rest_vars, strict=False,
        extra_skip_patterns=tuple(IMAGE_SKIP_PATTERNS))
    report["unmatched_torch"].extend(unmatched_bb)
    if strict and (report["unmatched_torch"] or report["unfilled_flax"]):
        raise ValueError(
            "image checkpoint conversion mismatch:\n  unmatched:\n    "
            + "\n    ".join(report["unmatched_torch"][:20])
            + "\n  unfilled:\n    "
            + "\n    ".join(report["unfilled_flax"][:20]))
    model.backbone.load_state_dict(backbone.state_dict())
    new_vars["params"]["backbone"] = to_jax_variables(model)["params"][
        "backbone"]
    from_jax_variables(model, new_vars)
    return report


# the reference's conv layouts of tensors the port keeps as (out, in)
_CONV_LAYOUTS = (
    (r"^backbone\.SA_modules\.\d+\.mlp_convs\.\d+\.weight$", 4),  # Conv2d
    (r"^backbone\.cov_final\.weight$", 3),                         # Conv1d
    (r"\.(stn|fstn)\.conv[123]\.weight$", 3),
    (r"\.feat\.conv[123]\.weight$", 3),
    (r"^backbone\.conv[1-4]\.0\.weight$", 4),
    (r"^backbone\.conv5\.0\.weight$", 3),
)


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The port model's weights (copies, on the model's device) under the
    reference's names and layouts: 1x1 convs as Conv1d / Conv2d weights,
    DGCNN's BatchNorms also under the backbone.conv{i}.1. names its
    Sequential blocks register, an image model's ViT under HF names. The
    loaders read it back bit for bit."""
    state = model.state_dict()
    vit = getattr(model, "backbone", None)
    if vit is not None and hasattr(vit, "blocks"):
        state = {k: v for k, v in state.items()
                 if not k.startswith("backbone.")}
        state.update({"backbone." + k: v
                      for k, v in hf_vit_state_dict(vit).items()})
    dgcnn = "backbone.conv5.0.weight" in state
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        v = v.detach().clone()
        for pat, ndim in _CONV_LAYOUTS:
            if v.ndim == 2 and re.search(pat, k):
                v = v.reshape(tuple(v.shape) + (1,) * (ndim - 2))
        out[k] = v
        m = re.match(r"^backbone\.bn([1-4])\.(.*)$", k)
        if dgcnn and m:
            out[f"backbone.conv{m.group(1)}.1.{m.group(2)}"] = v.clone()
    return out
