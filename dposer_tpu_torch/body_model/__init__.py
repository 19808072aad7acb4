from .smpl import BodyModel

__all__ = ["BodyModel"]
