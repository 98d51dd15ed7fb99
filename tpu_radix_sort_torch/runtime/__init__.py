"""Runtime layer: device timing, profiling, the native CPU baseline."""
from .profiler import annotate, trace
from .timing import device_time

__all__ = ["device_time", "trace", "annotate"]
