"""Move weights between the JAX package's flax variables and the port's
modules, both ways (from_jax_variables, to_jax_variables).

The inverse of the rewrite documented at
point_cloud_reid_tpu/convert/torch_checkpoint.py:20-29: flax paths track the
reference state-dict names, so each leaf maps to one port tensor by a string
rewrite plus a layout change:

    Dense kernel (in, out)           -> Linear weight (out, in)
    Norm scale                       -> weight
    BN batch_stats mean / var        -> running_mean / running_var
    sa_{i}/mlp_{j}/conv|bn           -> SA_modules.{i}.mlp_convs|mlp_bns.{j}
    fp_{i}                           -> FP_modules.{i}
    pos_mlp[2]/fc1|fc2, mlp_fc1|2    -> pos_mlp[2].0|2, mlp.0|2
    feat/(f)stn/convK|fcK/conv       -> feat.(f)stn.convK|fcK   (PointNet)
    feat/(f)stn/convK/bn             -> feat.(f)stn.bnK
    feat/(f)stn/fc1|fc2/bn           -> feat.(f)stn.bn4|bn5
    feat/conv1|2/conv, feat/conv1|2/bn -> feat.conv1|2, feat.bn1|2
    backbone/convK/conv|bn (K <= 4)  -> backbone.convK.0, backbone.bnK (DGCNN)
    backbone/conv5 (DGCNN's Dense)   -> backbone.conv5.0
    pos_mlp_knn/fc1|fc2, mlp_knn_fc1|2 -> pos_mlp_knn.0|2, mlp_knn.0|2
                                        (local self-attention)
    <stage>/loftr/layers_{i}/mlp_0|2 -> <stage>.loftr.layers.{i}.mlp.0|2
    downsample_conv|downsample_norm  -> downsample.0|1   (PostRes, Res1d)
    hgate_node_0, hgate_edge_0,
    poolingLayer_0                   -> hgate_node.0, ...   (gated pooling)
    (the vector-neuron layers' names are the same on both sides)
    <name>_head/{j}_<Type>           -> <name>_head.{j}   (match, cls, fp,
                                                          shape, vis)
    downsample/{j}_<Type>            -> downsample.{j}
    Conv kernel (k, in, out)         -> Conv1d weight (out, in, k)
    Conv kernel (h, w, in, out)      -> Conv2d weight (out, in, h, w)
    transform_linear|transform_norm  -> transform.0|1

and for the image model's ViT (the rules above cover its Dense and
LayerNorm leaves, block_i/mlp_fc1|2 included):

    backbone/block_{i}/              -> backbone.blocks.{i}.
    patch_embed kernel (p, p, 3, d)  -> Conv2d weight (d, 3, p, p)
    cls_token, dist_token, pos_embed, rel_pos_table, gamma_1|2 are bare
    parameters and keep their names. The flax 'consts' collection (BEiT's
    rel_pos_index) is not read: the port recomputes it as a buffer.

and for an LSTM (flax OptimizedLSTMCell, the motion model's `lstm`; both
sides order the gates i, f, g, o):

    lstm/{ii,if,ig,io}/kernel (F, H)   -> lstm.weight_ih_l0 = cat(...).T
    lstm/{hi,hf,hg,ho}/kernel (H, H)   -> lstm.weight_hh_l0 = cat(...).T
    lstm/{hi,hf,hg,ho}/bias            -> lstm.bias_hh_l0 = cat(...);
                                          lstm.bias_ih_l0 = 0
    (flax has no input-side bias: back to flax, bias_ih_l0 is folded into
    the h-side biases.)

The variables come as (nested dicts of) numpy arrays; nothing here imports
jax.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

_RULES = (
    (r"^backbone/sa_(\d+)/", r"backbone/SA_modules/\1/"),
    (r"^backbone/fp_(\d+)/", r"backbone/FP_modules/\1/"),
    (r"/SA_modules/(\d+)/mlp_(\d+)/conv/", r"/SA_modules/\1/mlp_convs/\2/"),
    (r"/SA_modules/(\d+)/mlp_(\d+)/bn/", r"/SA_modules/\1/mlp_bns/\2/"),
    (r"^backbone/block_(\d+)/", r"backbone/blocks/\1/"),
    (r"^((?:match|cls|fp|shape|vis)_head|downsample)/(\d+)_[A-Za-z0-9]+/",
     r"\1/\2/"),
    (r"pos_mlp(2?|_knn)/fc1/", r"pos_mlp\1/0/"),
    (r"pos_mlp(2?|_knn)/fc2/", r"pos_mlp\1/2/"),
    (r"(^|/)mlp(_knn)?_fc1/", r"\1mlp\2/0/"),
    (r"(^|/)mlp(_knn)?_fc2/", r"\1mlp\2/2/"),
    (r"(^|/)loftr/layers_(\d+)/mlp_([02])/", r"\1loftr/layers/\2/mlp/\3/"),
    (r"(^|/)loftr/layers_(\d+)/", r"\1loftr/layers/\2/"),
    (r"/downsample_conv/", r"/downsample/0/"),
    (r"/downsample_norm/", r"/downsample/1/"),
    (r"(^|/)(hgate_node|hgate_edge|poolingLayer)_0/", r"\1\2/0/"),
    (r"/transform_linear/", r"/transform/0/"),
    (r"/transform_norm/", r"/transform/1/"),
    # the inverse of the JAX converter's PointNet and DGCNN prefix rules
    # (point_cloud_reid_tpu/convert/torch_checkpoint.py _PREFIX_RULES)
    (r"/(stn|fstn)/conv([123])/conv/", r"/\1/conv\2/"),
    (r"/(stn|fstn)/conv([123])/bn/", r"/\1/bn\2/"),
    (r"/(stn|fstn)/fc1/bn/", r"/\1/bn4/"),
    (r"/(stn|fstn)/fc2/bn/", r"/\1/bn5/"),
    (r"/(stn|fstn)/fc([12])/conv/", r"/\1/fc\2/"),
    (r"/feat/conv([12])/conv/", r"/feat/conv\1/"),
    (r"/feat/conv([12])/bn/", r"/feat/bn\1/"),
    (r"^backbone/conv([1-4])/conv/", r"backbone/conv\1/0/"),
    (r"^backbone/conv([1-4])/bn/", r"backbone/bn\1/"),
    (r"^backbone/conv5/kernel$", r"backbone/conv5/0/kernel"),
)
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}
# bare parameters of the ViT: same name, same layout on both sides
_BARE = ("cls_token", "dist_token", "pos_embed", "rel_pos_table", "gamma_1",
         "gamma_2")


def _port_layout(kernel: np.ndarray) -> np.ndarray:
    """flax kernel -> torch weight: (in, out) -> (out, in), Conv1d (k, in,
    out) -> (out, in, k), Conv2d (h, w, in, out) -> (out, in, h, w)."""
    return kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T


def _flax_layout(weight: np.ndarray) -> np.ndarray:
    return weight.transpose(2, 3, 1, 0) if weight.ndim == 4 else weight.T


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


_GATES_I = ("ii", "if", "ig", "io")
_GATES_H = ("hi", "hf", "hg", "ho")
_LSTM_LEAF = re.compile(r"^(.*/)?lstm/(ii|if|ig|io|hi|hf|hg|ho)/(kernel|bias)$")


def _lstm_tensors(flat: Dict[str, np.ndarray]):
    """Split the LSTM leaves out of a flattened flax collection: (the other
    leaves, {port key: value} of the torch LSTMs' four tensors)."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    rest = {}
    for path, value in flat.items():
        m = _LSTM_LEAF.match(path)
        if m is None:
            rest[path] = value
            continue
        owner = (m.group(1) or "") + "lstm"
        groups.setdefault(owner, {})[f"{m.group(2)}/{m.group(3)}"] = value
    out = {}
    for owner, g in groups.items():
        key = owner.replace("/", ".")
        out[key + ".weight_ih_l0"] = np.concatenate(
            [g[f"{k}/kernel"] for k in _GATES_I], axis=1).T
        out[key + ".weight_hh_l0"] = np.concatenate(
            [g[f"{k}/kernel"] for k in _GATES_H], axis=1).T
        out[key + ".bias_hh_l0"] = np.concatenate(
            [g[f"{k}/bias"] for k in _GATES_H])
        out[key + ".bias_ih_l0"] = np.zeros_like(out[key + ".bias_hh_l0"])
    return rest, out


def _flax_lstm_leaves(lstm: torch.nn.LSTM, state: Dict[str, torch.Tensor],
                      owner: str) -> Dict[str, np.ndarray]:
    """A one-layer torch LSTM as flax OptimizedLSTMCell leaves, {path under
    the collection: value}."""
    if (lstm.num_layers != 1 or lstm.bidirectional or lstm.proj_size
            or not lstm.bias):
        raise ValueError(f"{owner}: only a one-layer unidirectional LSTM "
                         "with biases has a flax OptimizedLSTMCell twin")
    get = {k: state[f"{owner}.{k}"].detach().cpu().numpy()
           for k in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                     "bias_hh_l0")}
    H = lstm.hidden_size
    base = owner.replace(".", "/")
    out = {}
    for j, (gi, gh) in enumerate(zip(_GATES_I, _GATES_H)):
        rows = slice(j * H, (j + 1) * H)
        out[f"{base}/{gi}/kernel"] = get["weight_ih_l0"][rows].T
        out[f"{base}/{gh}/kernel"] = get["weight_hh_l0"][rows].T
        out[f"{base}/{gh}/bias"] = (get["bias_hh_l0"][rows]
                                    + get["bias_ih_l0"][rows])
    return out


def port_key(flax_path: str) -> Tuple[str, bool]:
    """flax collection-relative path -> (port state-dict key, whether the
    leaf is a kernel, whose layout _port_layout changes)."""
    path = flax_path
    for pat, rep in _RULES:
        path = re.sub(pat, rep, path)
    head, leaf = path.rsplit("/", 1)
    if leaf in _BARE:
        return path.replace("/", "."), False
    if leaf not in _LEAVES:
        raise ValueError(f"unknown flax leaf {flax_path}")
    return head.replace("/", ".") + "." + _LEAVES[leaf], leaf == "kernel"


@torch.no_grad()
def from_jax_variables(model: torch.nn.Module, variables: Dict[str, Any]
                       ) -> torch.nn.Module:
    """Copy flax {'params', 'batch_stats'} (numpy leaves) into `model`.

    Strict: every flax leaf must land on a port tensor of the same shape and
    every port parameter and buffer (bar BN's num_batches_tracked) must be
    set, otherwise ValueError lists what did not match."""
    state = model.state_dict(keep_vars=True)
    want = {k for k in state if not k.endswith("num_batches_tracked")}
    unused, filled = [], set()
    for collection in ("params", "batch_stats"):
        flat, lstm = _lstm_tensors(_flatten(variables.get(collection, {})))
        for key, value in lstm.items():
            if key not in want or tuple(state[key].shape) != value.shape:
                unused.append(f"{collection}:{key} {value.shape}")
                continue
            state[key].copy_(torch.tensor(value))
            filled.add(key)
        for path, value in flat.items():
            key, transpose = port_key(path)
            if transpose:
                value = _port_layout(value)
            if key not in want or tuple(state[key].shape) != value.shape:
                unused.append(f"{collection}:{path} -> {key} {value.shape}")
                continue
            state[key].copy_(torch.tensor(value))
            filled.add(key)
    missing = sorted(want - filled)
    if unused or missing:
        raise ValueError("flax -> port mismatch:\n  unused flax leaves:\n    "
                         + "\n    ".join(unused[:20])
                         + "\n  unset port tensors:\n    "
                         + "\n    ".join(missing[:20]))
    return model


_INVERSE = (
    (r"^backbone\.SA_modules\.(\d+)\.mlp_convs\.(\d+)\.",
     r"backbone/sa_\1/mlp_\2/conv/"),
    (r"^backbone\.SA_modules\.(\d+)\.mlp_bns\.(\d+)\.",
     r"backbone/sa_\1/mlp_\2/bn/"),
    (r"^backbone\.SA_modules\.(\d+)\.", r"backbone/sa_\1/"),
    (r"^backbone\.FP_modules\.(\d+)\.", r"backbone/fp_\1/"),
    (r"^backbone\.blocks\.(\d+)\.", r"backbone/block_\1/"),
    (r"pos_mlp(2?|_knn)\.0\.", r"pos_mlp\1/fc1/"),
    (r"pos_mlp(2?|_knn)\.2\.", r"pos_mlp\1/fc2/"),
    # a LoFTR layer's FFN keeps the reference's indices; before mlp.0 / 2
    (r"(^|\.)loftr\.layers\.(\d+)\.mlp\.([02])\.",
     r"\1loftr.layers_\2.mlp_\3."),
    (r"(^|\.)loftr\.layers\.(\d+)\.", r"\1loftr.layers_\2."),
    (r"(^|[./])mlp(_knn)?\.0\.", r"\1mlp\2_fc1/"),
    (r"(^|[./])mlp(_knn)?\.2\.", r"\1mlp\2_fc2/"),
    (r"/downsample\.0\.", r"/downsample_conv/"),
    (r"/downsample\.1\.", r"/downsample_norm/"),
    (r"(^|\.)(hgate_node|hgate_edge|poolingLayer)\.0\.", r"\1\2_0/"),
    (r"(^|[./])transform\.0\.", r"\1transform_linear/"),
    (r"(^|[./])transform\.1\.", r"\1transform_norm/"),
    # PointNet and DGCNN; a transform's convK / fcK first, so that the
    # BatchNorms' new paths are not rewritten again
    (r"\.(stn|fstn)\.conv([123])\.", r".\1.conv\2.conv."),
    (r"\.(stn|fstn)\.fc([12])\.", r".\1.fc\2.conv."),
    (r"\.(stn|fstn)\.bn([123])\.", r".\1.conv\2.bn."),
    (r"\.(stn|fstn)\.bn4\.", r".\1.fc1.bn."),
    (r"\.(stn|fstn)\.bn5\.", r".\1.fc2.bn."),
    (r"\.feat\.conv([12])\.", r".feat.conv\1.conv."),
    (r"\.feat\.bn([12])\.", r".feat.conv\1.bn."),
    (r"^backbone\.conv([1-4])\.0\.", r"backbone.conv\1.conv."),
    (r"^backbone\.bn([1-4])\.", r"backbone.conv\1.bn."),
    (r"^backbone\.conv5\.0\.", r"backbone.conv5."),
)


def to_jax_variables(model: torch.nn.Module) -> Dict[str, Any]:
    """The port's weights as a flax {'params', 'batch_stats'} tree of numpy
    arrays: the inverse of from_jax_variables, so both packages can start
    from one init. The arrays are copies: training the model afterwards
    leaves the tree as it was."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    modules = dict(model.named_modules())
    state = model.state_dict()

    def put(coll, path, leaf, v):
        node = tree[coll]
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node[leaf] = np.array(v, copy=True, order="C")

    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        owner, leaf = key.rsplit(".", 1)
        mod = modules[owner]
        if isinstance(mod, torch.nn.LSTM):
            if leaf == "weight_ih_l0":      # once per LSTM
                for path, v in _flax_lstm_leaves(mod, state, owner).items():
                    head, name = path.rsplit("/", 1)
                    put("params", head, name, v)
            continue
        path = owner + "."
        m = re.match(r"^([a-z]+_head|downsample)\.(\d+)\.", path)
        if m:
            head, j = m.group(1), int(m.group(2))
            path = f"{head}/{j}_{modules[head].types[j]}/" + path[m.end():]
        for pat, rep in _INVERSE:
            path = re.sub(pat, rep, path)
        path = path.replace(".", "/").strip("/")
        v = value.detach().cpu().numpy()
        coll = "params"
        if leaf == "weight" and isinstance(mod, (torch.nn.Linear,
                                                 torch.nn.Conv1d,
                                                 torch.nn.Conv2d)):
            leaf, v = "kernel", _flax_layout(v)
        elif leaf == "weight":
            leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        put(coll, path, leaf, v)
    return tree
