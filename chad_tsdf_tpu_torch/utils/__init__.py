from .timing import JsonMetricsSink, StageTimer, profile_insert, trace  # noqa: F401
