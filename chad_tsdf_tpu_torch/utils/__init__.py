from .timing import (COUNTS, JsonMetricsSink, StageTimer, count,  # noqa: F401
                     counts, profile_insert, profiled, span, trace)
