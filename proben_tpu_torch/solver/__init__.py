from .build import SGDMomentum, SolverConfig, build_lr_schedule, build_optimizer

__all__ = ["SGDMomentum", "SolverConfig", "build_lr_schedule", "build_optimizer"]
