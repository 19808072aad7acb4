from .sde import SDE, VESDE, VPSDE, SubVPSDE, build_sde, sampling_eps_for

__all__ = ["SDE", "VESDE", "VPSDE", "SubVPSDE", "build_sde", "sampling_eps_for"]
