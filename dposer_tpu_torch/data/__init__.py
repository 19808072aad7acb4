from .normalizer import PoseNormalizer

__all__ = ["PoseNormalizer"]
