"""Cross-cutting infrastructure: event emitter, Moore-machine FSM base,
metrics, causal tracing and logging (the port's own copy of
``zkstream_tpu.utils``)."""

from .events import EventEmitter  # noqa: F401
from .fsm import FSM, StateScope  # noqa: F401
from .logging import Logger  # noqa: F401
from .metrics import Collector, Counter, Gauge, Histogram  # noqa: F401
from .trace import Span, TraceRing  # noqa: F401
