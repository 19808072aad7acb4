from .score_mlp import ScoreModelFC, TimeMLPs, create_score_model, get_act, get_sigmas
from .time_embedding import GaussianFourierProjection, get_timestep_embedding

__all__ = ["ScoreModelFC", "TimeMLPs", "create_score_model", "get_act", "get_sigmas",
           "GaussianFourierProjection", "get_timestep_embedding"]
