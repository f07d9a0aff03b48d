"""The tracker-era model zoo: the heads and backbones the JAX package's
CLIs reach through --set on a registered leaf, as (leaf, --set list).
tools/train.py, tools/test.py and tools/track.py take the same strings:

    python -m point_cloud_reid_tpu_torch.tools.track LEAF --set S1 --set S2

  xcorr          the 'xcorr' match type: cross and local self-attention
                 stages in turn (LocalSelfAttention, knum 32);
  xcorr-pallas   the same with the local stages on the linear-attention
                 kernel ('linear-pallas': one query, 32 keys a point);
  cosine         ReIDNetCosine: 10 x the cosine of the pooled embeddings;
  loftr          LoFTR cross stages, softmax attention ('full');
  loftr-linear   the same with linear attention;
  vn_dgcnn       the DGCNN leaf on the VN-DGCNN backbone (2046-wide
                 features through the leaf's Linear(64) downsample);
  add, minus     xcorr_eff with another combine;
  cat            combine 'cat' (a 256-wide match head input);
  max            pool_type 'max' (a 64-wide match head input).
"""
from __future__ import annotations

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
DGCNN = "pts_dgcnn_point-cat_nus_det_4x256_500e"


def _local(attention: str = "linear") -> str:
    extra = "" if attention == "linear" else f",'attention':'{attention}'"
    return ("{'type':'local_self_attention','d_model':64,'nhead':2,"
            f"'knum':32,'pos_size':64{extra}}}")


def _loftr(attention: str) -> str:
    return ("{'type':'loftr','d_model':64,'nhead':2,"
            f"'attention':'{attention}','n_layers':2}}")


def _head(n_in: int) -> str:
    return (f"[{{'type':'LinearRes','n_in':{n_in},'n_out':128,'norm':'GN',"
            "'ng':8},{'type':'Linear','out_features':1}]")


ZOO = {
    "xcorr": (FLAGSHIP, ["model.match_type=xcorr",
                         f"model.local_stage1={_local()}",
                         f"model.local_stage2={_local()}"]),
    "xcorr-pallas": (FLAGSHIP, [
        "model.match_type=xcorr",
        f"model.local_stage1={_local('linear-pallas')}",
        f"model.local_stage2={_local('linear-pallas')}"]),
    "cosine": (FLAGSHIP, ["model.type=ReIDNetCosine"]),
    "loftr": (FLAGSHIP, [f"model.cross_stage1={_loftr('full')}",
                         f"model.cross_stage2={_loftr('full')}"]),
    "loftr-linear": (FLAGSHIP, [f"model.cross_stage1={_loftr('linear')}",
                                f"model.cross_stage2={_loftr('linear')}"]),
    "vn_dgcnn": (DGCNN, ["model.backbone.type=vn_dgcnn"]),
    "add": (FLAGSHIP, ["model.combine=add"]),
    "minus": (FLAGSHIP, ["model.combine=minus"]),
    "cat": (FLAGSHIP, ["model.combine=cat",
                       f"model.match_head={_head(256)}"]),
    "max": (FLAGSHIP, ["model.pool_type=max",
                       f"model.match_head={_head(64)}"]),
}
