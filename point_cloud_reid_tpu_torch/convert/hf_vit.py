"""HuggingFace DeiT / BEiT weights onto the port's ViT backbone.

Port of point_cloud_reid_tpu/convert/hf_vit.py. The reference's image branch
uses HF torch backbones, so a released ImageReIDNet checkpoint holds
HF-named weights under the 'backbone.' prefix:

    embeddings.cls_token / distillation_token / position_embeddings
    embeddings.patch_embeddings.projection.{weight,bias}  -> patch_embed
    encoder.layer.{i}.layernorm_before / layernorm_after  -> blocks.i.norm1 / norm2
    encoder.layer.{i}.attention.attention.{query,key,value} -> fused attn.qkv
    encoder.layer.{i}.attention.output.dense              -> blocks.i.attn.proj
    encoder.layer.{i}.intermediate.dense                  -> blocks.i.mlp.0
    encoder.layer.{i}.output.dense                        -> blocks.i.mlp.2
    encoder.layer.{i}.lambda_1 / lambda_2                 -> gamma_1 / gamma_2 (BEiT)
    layernorm                                             -> norm (BEiT only: DeiT taps
        the last block before the final LayerNorm, so those weights are dead)
    relative_position_bias_table                          -> rel_pos_table (BEiT)

Both sides are torch layouts, so nothing is transposed; q, k and v are
concatenated into the fused projection in that order (BEiT has no key bias:
zeros). The relative-position index and the pooler are not weights of the
port and are skipped.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

_DIRECT = {
    "embeddings.cls_token": "cls_token",
    "embeddings.distillation_token": "dist_token",
    "embeddings.position_embeddings": "pos_embed",
    "embeddings.patch_embeddings.projection.weight": "patch_embed.weight",
    "embeddings.patch_embeddings.projection.bias": "patch_embed.bias",
}
_LAYER = {
    "attention.output.dense": "attn.proj",
    "layernorm_before": "norm1",
    "layernorm_after": "norm2",
    "intermediate.dense": "mlp.0",
    "output.dense": "mlp.2",
}
_REL_TABLE = ("attention.attention.relative_position_bias."
              "relative_position_bias_table")


@torch.no_grad()
def convert_hf_vit_state_dict(sd: Dict[str, np.ndarray], vit: torch.nn.Module,
                              prefix: str = "") -> List[str]:
    """Copy an HF state dict (numpy arrays or tensors, keys optionally under
    `prefix`) into `vit` in place. Returns the keys that matched nothing, or
    matched a tensor of another shape (with the reason appended)."""
    state = vit.state_dict(keep_vars=True)
    unmatched: List[str] = []
    qkv: Dict[int, Dict[str, torch.Tensor]] = {}

    def put(name: str, key: str, value: torch.Tensor) -> None:
        if name not in state:
            unmatched.append(f"{key} (no {name} in this ViT)")
        elif tuple(state[name].shape) != tuple(value.shape):
            unmatched.append(f"{key} ({tuple(value.shape)} != "
                             f"{tuple(state[name].shape)} of {name})")
        else:
            state[name].copy_(value)

    for key, value in sd.items():
        if prefix and not key.startswith(prefix):
            unmatched.append(key)
            continue
        k = key[len(prefix):]
        v = torch.as_tensor(np.asarray(value))
        if k in _DIRECT:
            put(_DIRECT[k], key, v)
        elif k in ("layernorm.weight", "layernorm.bias"):
            if "norm.weight" in state:              # BEiT; dead for DeiT
                put("norm." + k.split(".")[1], key, v)
        elif "relative_position_index" in k or k.startswith("pooler."):
            pass                                    # recomputed / unused
        elif "relative_position_bias_table" in k and not k.startswith(
                "encoder.layer."):
            put("rel_pos_table", key, v)
        elif (m := re.match(r"encoder\.layer\.(\d+)\.(.*)$", k)):
            i, rest = int(m.group(1)), m.group(2)
            block = f"blocks.{i}."
            part, _, leaf = rest.rpartition(".")
            if (m2 := re.match(r"attention\.attention\.(query|key|value)\."
                               r"(weight|bias)$", rest)):
                qkv.setdefault(i, {})[f"{m2.group(1)}.{m2.group(2)}"] = v
            elif rest == _REL_TABLE:
                put("rel_pos_table", key, v)        # per layer: the last wins
            elif part in _LAYER and leaf in ("weight", "bias"):
                put(block + _LAYER[part] + "." + leaf, key, v)
            elif rest in ("lambda_1", "lambda_2"):
                put(block + "gamma_" + rest[-1], key, v)
            else:
                unmatched.append(key)
        else:
            unmatched.append(key)

    for i, parts in qkv.items():
        weights = [parts.get(f"{n}.weight") for n in ("query", "key", "value")]
        if any(w is None for w in weights):
            unmatched.append(f"encoder.layer.{i}: incomplete q/k/v")
            continue
        dim = weights[0].shape[0]
        zeros = torch.zeros(dim, dtype=weights[0].dtype)
        biases = [parts.get(f"{n}.bias", zeros)
                  for n in ("query", "key", "value")]
        tag = f"{prefix}encoder.layer.{i}.attention.attention"
        put(f"blocks.{i}.attn.qkv.weight", tag, torch.cat(weights, dim=0))
        put(f"blocks.{i}.attn.qkv.bias", tag, torch.cat(biases, dim=0))
    return unmatched
