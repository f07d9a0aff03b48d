from .attention_blocks import LocalSelfAttention
from .build import build_model, init_weights
from .image_reid import ImageReIDNet
from .layers import PostRes, Res1d
from .loftr import LoFTRStage, LocalFeatureTransformer, LoFTREncoderLayer
from .node_pooling import EdgeGatedPooling, GatedPooling
from .reid_net import ReIDNet, ReIDNetCosine
from .vector_neurons import VNDGCNNBackbone

__all__ = ["build_model", "init_weights", "EdgeGatedPooling", "GatedPooling",
           "ImageReIDNet", "LocalFeatureTransformer", "LocalSelfAttention",
           "LoFTREncoderLayer", "LoFTRStage", "PostRes", "ReIDNet",
           "ReIDNetCosine", "Res1d", "VNDGCNNBackbone"]
