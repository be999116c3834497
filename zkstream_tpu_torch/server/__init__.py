"""In-process ZooKeeper server: data model, wire server, write-ahead
log, watch table, ensemble simulation, and cross-process member
replication and election (the port's own copy of
``zkstream_tpu.server``)."""

from .persist import (  # noqa: F401
    WriteAheadLog,
    attach_wal,
    open_wal_database,
    recover_state,
    scan_dir,
)
from .replication import (  # noqa: F401
    RemoteLeader,
    RemoteReplicaStore,
    ReplicationService,
)
from .server import ServerConnection, ZKEnsemble, ZKServer  # noqa: F401
from .watchtable import WatchTable, watchtable_default  # noqa: F401
from .store import (  # noqa: F401
    NodeTree,
    ReplicaStore,
    ZKDatabase,
    ZKOpError,
    ZKServerSession,
    Znode,
)
