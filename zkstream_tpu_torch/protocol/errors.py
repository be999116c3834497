"""Error classes for the zkstream_tpu_torch client (a copy of zkstream_tpu's).

Mirrors the reference's four error classes (reference: lib/errors.js:9-54):
transport/framing problems, ping timeouts, not-connected, and server-side
operation errors.
"""

from __future__ import annotations

from .consts import ERR_TEXT, ErrCode


class ZKProtocolError(Exception):
    """A transport- or framing-level protocol problem (bad length prefix,
    undecodable packet, version mismatch...).  ``code`` is a short
    machine-readable string such as ``'BAD_LENGTH'`` or ``'BAD_DECODE'``
    (reference: lib/errors.js:19-28)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class ZKPingTimeoutError(ZKProtocolError):
    """The server failed to answer a keep-alive ping in time
    (reference: lib/errors.js:30-35)."""

    def __init__(self) -> None:
        super().__init__('PING_TIMEOUT', 'Timed out while waiting for ping '
            'reply from ZK server')


class ZKDeadlineError(ZKProtocolError):
    """A client operation exceeded its per-request deadline.  Typed so
    callers can distinguish "the connection is wedged / the server is
    not answering" (retryable, outcome unknown) from a definite server
    verdict; ``code`` is ``'DEADLINE_EXCEEDED'``."""

    def __init__(self, opcode: str, path: str | None = None,
                 deadline_ms: float | None = None):
        where = ' %s' % (path,) if path else ''
        after = '' if deadline_ms is None else ' after %d ms' \
            % (deadline_ms,)
        super().__init__('DEADLINE_EXCEEDED',
            'Deadline exceeded%s waiting for %s%s reply'
            % (after, opcode, where))
        self.opcode = opcode
        self.path = path
        self.deadline_ms = deadline_ms


class ZKFrameTooLargeError(ZKProtocolError):
    """An inbound length prefix exceeded the frame-size cap
    (``ZKSTREAM_MAX_FRAME``, the ``jute.maxbuffer`` analogue).  Typed
    so both directions can reject the frame BEFORE buffering it — a
    corrupt or hostile 4-byte prefix must never make a peer try to
    allocate gigabytes; ``code`` is ``'FRAME_TOO_LARGE'``."""

    def __init__(self, length: int, cap: int):
        super().__init__('FRAME_TOO_LARGE',
            'Inbound ZK frame of %d bytes exceeds the %d-byte cap'
            % (length, cap))
        self.length = length
        self.cap = cap


class ZKNotConnectedError(ZKProtocolError):
    """An operation was attempted while no usable connection exists
    (reference: lib/errors.js:37-42)."""

    def __init__(self) -> None:
        super().__init__('CONNECTION_LOSS',
            'Not connected to a ZooKeeper server')


class ZKError(Exception):
    """A server-side operation error: the reply header carried a non-OK
    error code (reference: lib/errors.js:44-54).  ``code`` is the error
    name (e.g. ``'NO_NODE'``); ``errno`` the numeric protocol code."""

    def __init__(self, code: str, message: str | None = None):
        if message is None:
            message = ERR_TEXT.get(code) or code
        super().__init__(message)
        self.code = code
        self.message = message
        try:
            self.errno: int | None = int(ErrCode[code])
        except KeyError:
            self.errno = None


class ZKThrottledError(ZKError):
    """The serving member bounced a write at its global memory
    watermark (io/overload.py): a definite, typed failure — the write
    was NOT applied.  Reads keep flowing on the same connection; the
    client's write path backs off (capped exponential, the session's
    retry policy) and re-issues."""

    def __init__(self, message: str | None = None):
        super().__init__('THROTTLED', message)


class ZKMultiError(ZKError):
    """A MULTI transaction was rejected: no sub-op was applied
    (all-or-nothing, server/store.py ``ZKDatabase.multi``).  ``code``
    is the first failing sub-op's error; ``results`` holds the per-op
    outcome dicts exactly as the wire carried them (failed ops as
    ``{'op': 'error', 'err': <code>}``), and ``index`` names the first
    failing position."""

    def __init__(self, results: list):
        self.results = results
        self.index = next(
            (i for i, r in enumerate(results) if r.get('op') == 'error'
             and r.get('err') not in (None, 'OK',
                                      'RUNTIME_INCONSISTENCY')),
            next((i for i, r in enumerate(results)
                  if r.get('op') == 'error'), 0))
        code = (results[self.index].get('err', 'API_ERROR')
                if results else 'API_ERROR')
        super().__init__(code, 'multi rejected at op %d: %s (no sub-op '
                               'was applied)' % (self.index, code))
