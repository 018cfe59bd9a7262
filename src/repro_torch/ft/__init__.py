from .failures import FailureDetector, FailureEvent, replan_data_parallel

__all__ = ["FailureDetector", "FailureEvent", "replan_data_parallel"]
