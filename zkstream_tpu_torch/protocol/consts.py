"""ZooKeeper wire-protocol constant tables.

Protocol facts (opcodes, error codes, permission masks, create flags,
notification types, keeper states, special transaction ids) mirror the
reference client's tables (reference: lib/zk-consts.js:13-138) and the
upstream ZooKeeper jute definitions.  Expressed as Python enums so both
directions of lookup (name -> value, value -> name) come for free.
"""

from __future__ import annotations

import enum


class Perm(enum.IntFlag):
    """ACL permission bit-masks (reference: lib/zk-consts.js:13-19)."""

    READ = 1 << 0
    WRITE = 1 << 1
    CREATE = 1 << 2
    DELETE = 1 << 3
    ADMIN = 1 << 4

    ALL = READ | WRITE | CREATE | DELETE | ADMIN


class CreateFlag(enum.IntFlag):
    """Znode create-mode bit-masks (reference: lib/zk-consts.js:21-24)."""

    EPHEMERAL = 1 << 0
    SEQUENTIAL = 1 << 1


class ErrCode(enum.IntEnum):
    """Server error codes (reference: lib/zk-consts.js:26-47)."""

    OK = 0
    SYSTEM_ERROR = -1
    RUNTIME_INCONSISTENCY = -2
    DATA_INCONSISTENCY = -3
    CONNECTION_LOSS = -4
    MARSHALLING_ERROR = -5
    UNIMPLEMENTED = -6
    OPERATION_TIMEOUT = -7
    BAD_ARGUMENTS = -8
    API_ERROR = -100
    NO_NODE = -101
    NO_AUTH = -102
    BAD_VERSION = -103
    NO_CHILDREN_FOR_EPHEMERALS = -108
    NODE_EXISTS = -110
    NOT_EMPTY = -111
    SESSION_EXPIRED = -112
    INVALID_CALLBACK = -113
    INVALID_ACL = -114
    AUTH_FAILED = -115
    #: This stack's own (no reference analogue): a write reached a
    #: member whose leadership epoch is stale — a deposed leader, or a
    #: follower forwarding under an epoch the quorum has moved past
    #: (server/election.py).  Typed, definite failure: the write was
    #: NOT applied; retry after the member rejoins the current epoch.
    EPOCH_FENCED = -130
    #: This stack's own (no reference analogue): the serving member is
    #: shedding load — its global memory watermark is crossed and new
    #: writes bounce while reads keep flowing (io/overload.py).  Typed,
    #: definite failure: the write was NOT applied; the client backs
    #: off and retries (capped exponential, client.py).
    THROTTLED = -131


#: Human-readable explanations for ErrCode values
#: (reference: lib/zk-consts.js:53-82).
ERR_TEXT: dict[str, str] = {
    'SYSTEM_ERROR': 'An unknown system error occurred on the ZooKeeper '
        'server',
    'RUNTIME_INCONSISTENCY': 'A runtime inconsistency was found, and the '
        'request aborted for safety',
    'DATA_INCONSISTENCY': 'A data inconsistency was found, and the request '
        'aborted for safety',
    'CONNECTION_LOSS': 'Connection to the ZooKeeper server has been lost',
    'MARSHALLING_ERROR': 'Error while marshalling or unmarshalling data',
    'UNIMPLEMENTED': 'ZooKeeper request unimplemented',
    'OPERATION_TIMEOUT': 'ZooKeeper operation timed out',
    'BAD_ARGUMENTS': 'Bad arguments to ZooKeeper request',
    'API_ERROR': '',
    'NO_NODE': 'The specified ZooKeeper path does not exist',
    'NO_AUTH': 'Request requires authentication and your ZooKeeper '
        'connection is anonymous',
    'BAD_VERSION': 'A specific version of an object was named in the '
        'request, but this was not the latest version on the server. The '
        'object may have been changed by another client.',
    'NO_CHILDREN_FOR_EPHEMERALS': 'Ephemeral nodes cannot have children',
    'NODE_EXISTS': 'The specified ZooKeeper path already exists, and the '
        'requested operation requires creating a new node',
    'NOT_EMPTY': 'The specified ZooKeeper node has children and thus '
        'cannot be destroyed',
    'SESSION_EXPIRED': 'ZooKeeper session expired',
    'INVALID_CALLBACK': '',
    'INVALID_ACL': 'The given ZooKeeper ACL was found to be invalid on '
        'the server side',
    'AUTH_FAILED': 'ZooKeeper authentication failed',
    'EPOCH_FENCED': 'The serving member\'s leadership epoch is stale '
        '(a newer leader has been elected); the write was rejected, '
        'not applied',
    'THROTTLED': 'The serving member is overloaded and shedding new '
        'writes (reads keep flowing); the write was rejected, not '
        'applied — back off and retry',
}


class OpCode(enum.IntEnum):
    """Request opcodes (reference: lib/zk-consts.js:84-105)."""

    NOTIFICATION = 0
    CREATE = 1
    DELETE = 2
    EXISTS = 3
    GET_DATA = 4
    SET_DATA = 5
    GET_ACL = 6
    SET_ACL = 7
    GET_CHILDREN = 8
    SYNC = 9
    PING = 11
    GET_CHILDREN2 = 12
    CHECK = 13
    MULTI = 14
    AUTH = 100
    SET_WATCHES = 101
    SASL = 102
    #: This stack's extension beyond the reference client (whose
    #: consts table stops at SASL): the upstream ZooKeeper 3.6+
    #: persistent-watch opcode family.  ADD_WATCH arms a watch that
    #: SURVIVES fires (mode below); SET_WATCHES2 is the reconnect
    #: replay carrying the two persistent lists alongside the three
    #: legacy one-shot lists.
    ADD_WATCH = 106
    SET_WATCHES2 = 107
    CREATE_SESSION = -10
    CLOSE_SESSION = -11
    ERROR = -1


class AddWatchMode(enum.IntEnum):
    """ADD_WATCH subscription modes (upstream ZooKeeper AddWatchMode).

    PERSISTENT: survives fires on the exact node, receives every
    notification type.  PERSISTENT_RECURSIVE: survives fires and
    matches the node plus every descendant, receiving CREATED /
    DELETED / DATA_CHANGED (no CHILDREN_CHANGED — a recursive
    subscriber sees the child's own CREATED/DELETED instead)."""

    PERSISTENT = 0
    PERSISTENT_RECURSIVE = 1


class NotificationType(enum.IntEnum):
    """Watch-event types carried in NOTIFICATION packets
    (reference: lib/zk-consts.js:111-116)."""

    CREATED = 1
    DELETED = 2
    DATA_CHANGED = 3
    CHILDREN_CHANGED = 4


class KeeperState(enum.IntEnum):
    """Keeper states carried in NOTIFICATION packets
    (reference: lib/zk-consts.js:122-129)."""

    DISCONNECTED = 0
    SYNC_CONNECTED = 3
    AUTH_FAILED = 4
    CONNECTED_READ_ONLY = 5
    SASL_AUTHENTICATED = 6
    EXPIRED = -122


#: Reserved transaction ids: replies carrying one of these are not matched
#: against an outstanding request's xid (reference: lib/zk-consts.js:135-138).
XID_NOTIFICATION = -1
XID_PING = -2
XID_AUTHENTICATION = -4
XID_SET_WATCHES = -8

#: Reply xid -> pseudo-opcode for the special xids above
#: (reference: lib/zk-buffer.js:275-279).
SPECIAL_XIDS: dict[int, str] = {
    XID_NOTIFICATION: 'NOTIFICATION',
    XID_PING: 'PING',
    XID_AUTHENTICATION: 'AUTH',
    XID_SET_WATCHES: 'SET_WATCHES',
}

#: Only protocol version 0 is spoken (reference: lib/connection-fsm.js:141).
PROTOCOL_VERSION = 0

#: Frame-size sanity cap applied by the decoder
#: (reference: lib/zk-streams.js:23).
MAX_PACKET = 16 * 1024 * 1024

#: Reply header width: xid:int32 + zxid:int64 + err:int32
#: (reference: lib/zk-buffer.js:281-284).
REPLY_HDR = 16


def err_name(code: int) -> str:
    """Map a numeric error code to its name; unknown codes become
    ``'ERROR_<n>'`` rather than raising, since a misbehaving server must
    not crash the decoder."""
    try:
        return ErrCode(code).name
    except ValueError:
        return 'ERROR_%d' % (code,)


def op_name(code: int) -> str:
    """Map a numeric opcode to its name (raises ValueError if unknown)."""
    return OpCode(code).name
