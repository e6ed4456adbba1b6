from .schedule import DiffusionSchedule, make_beta_schedule, subsample_schedule

__all__ = ["DiffusionSchedule", "make_beta_schedule", "subsample_schedule"]
