from .pair_scoring import DeviceTrackCache, FeatureCache, PairScorer

__all__ = ["DeviceTrackCache", "FeatureCache", "PairScorer"]
