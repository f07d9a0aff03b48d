from .build import build_model, init_weights
from .image_reid import ImageReIDNet
from .reid_net import ReIDNet

__all__ = ["build_model", "init_weights", "ImageReIDNet", "ReIDNet"]
