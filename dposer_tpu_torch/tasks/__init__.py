from .completion import DPoserComp
from .prior import DPoserPrior

__all__ = ["DPoserComp", "DPoserPrior"]
