from .completion import DPoserComp
from .motion_denoising import MotionDenoise
from .prior import DPoserPrior
from .smplify import DPoser, SMPLify

__all__ = ["DPoser", "DPoserComp", "DPoserPrior", "MotionDenoise", "SMPLify"]
