from .amass import AMASSDataset
from .normalizer import PoseNormalizer

__all__ = ["AMASSDataset", "PoseNormalizer"]
