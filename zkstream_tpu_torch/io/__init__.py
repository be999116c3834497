"""Connection, session, watcher and pool layers, the fleet ingest
that batches their receive decode onto the device, and the seeded
fault plane with its history invariants (the port's own copy of
``zkstream_tpu.io``)."""

from .backoff import Backoff, BackoffPolicy  # noqa: F401
from .connection import Backend, ZKConnection, ZKRequest  # noqa: F401
from .faults import FaultConfig, FaultInjector, FaultPlan  # noqa: F401
from .ingest import FleetIngest  # noqa: F401
from .invariants import History, check_history  # noqa: F401
from .pool import ConnectionPool, RecoveryPolicy  # noqa: F401
from .session import ZKSession  # noqa: F401
from .watcher import LostWakeupError, ZKWatcher, ZKWatchEvent  # noqa: F401
