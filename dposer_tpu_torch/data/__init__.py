from .amass import AMASSDataset
from .mocap import MocapDataset
from .normalizer import PoseNormalizer

__all__ = ["AMASSDataset", "MocapDataset", "PoseNormalizer"]
