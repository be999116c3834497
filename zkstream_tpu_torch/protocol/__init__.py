"""Wire-protocol layers: constants, errors, jute primitives, message
records, framing (the port's own copy of ``zkstream_tpu.protocol``)."""

from . import consts, errors, framing, jute, records  # noqa: F401
from .consts import (  # noqa: F401
    MAX_PACKET,
    PROTOCOL_VERSION,
    CreateFlag,
    ErrCode,
    KeeperState,
    NotificationType,
    OpCode,
    Perm,
)
from .errors import (  # noqa: F401
    ZKError,
    ZKFrameTooLargeError,
    ZKNotConnectedError,
    ZKPingTimeoutError,
    ZKProtocolError,
)
from .framing import FrameDecoder, PacketCodec, frame  # noqa: F401
from .jute import JuteReader, JuteWriter  # noqa: F401
from .records import ACL, OPEN_ACL_UNSAFE, Id, Stat  # noqa: F401
