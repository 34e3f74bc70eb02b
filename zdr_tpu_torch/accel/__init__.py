"""Ray-triangle intersection: the dense sweep and the escape-link BVH
(port of zdr_tpu/accel)."""

from .build import build_accel
from .trace import trace_any, trace_closest
from .types import Accel, Hit

__all__ = ["Accel", "Hit", "build_accel", "trace_any", "trace_closest"]
