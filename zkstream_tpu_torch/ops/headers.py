"""Batched reply-header parse and per-stream session reductions.

Every steady-state reply starts with a 16-byte header — xid:int32,
zxid:int64, err:int32 (reference: lib/zk-buffer.js:275-331) — and the
connected-state drain loop routes each packet on its xid: NOTIFICATION
(-1) to the watcher engine, PING (-2) to the keepalive, everything
else to the pending-request table (lib/connection-fsm.js:213-229).
The session separately tracks the largest zxid seen across all replies
— its resume checkpoint (lib/zk-session.js:229-235).

``parse_reply_headers`` is the plain version of K1's header half;
``stream_stats`` stays plain torch on every device (a few [B, F] ->
[B] reductions).
"""

from __future__ import annotations

import torch

from .bytesops import be_i32_at, be_i64pair_at, u64pair_reduce_max

XID_NOTIFICATION = -1
XID_PING = -2
XID_AUTH = -4
XID_SET_WATCHES = -8


def parse_reply_headers(buf, starts, sizes=None):
    """Parse reply headers at each frame start.

    Args:
      buf: uint8 [B, L] stream bytes.
      starts: int32 [B, F] frame body offsets (-1 = no frame).
      sizes: int32 [B, F] frame body lengths; when given, frames
        shorter than the 16-byte reply header are excluded from
        ``valid`` (and surfaced via ``short``).

    Returns dict of int32 [B, F] arrays: ``xid``, ``zxid_hi``,
    ``zxid_lo``, ``err`` — values are 0 where ``valid`` is False —
    plus bool masks ``valid`` and ``short``.
    """
    valid = starts >= 0
    short = valid & (sizes < 16) if sizes is not None else (
        torch.zeros_like(valid))
    valid = valid & ~short
    off = torch.where(valid, starts, 0)
    xid = torch.where(valid, be_i32_at(buf, off), 0)
    zh, zl = be_i64pair_at(buf, off + 4)
    err = be_i32_at(buf, off + 12)
    return {
        'valid': valid,
        'short': short,
        'xid': xid,
        'zxid_hi': torch.where(valid, zh, 0),
        'zxid_lo': torch.where(valid, zl, 0),
        'err': torch.where(valid, err, 0),
    }


def stream_stats(headers):
    """Per-stream reductions over parsed headers: routing counts and
    the max zxid for the session checkpoint.  Notifications carry zxid
    -1 on the wire and must not advance the checkpoint — the valid
    mask plus the xid >= 0 filter keeps them out.

    Returns dict of int32 [B] arrays: ``n_replies``, ``n_notifications``,
    ``n_pings``, ``n_errors``, ``max_zxid_hi``, ``max_zxid_lo``.
    """
    valid = headers['valid']
    xid = headers['xid']
    err = headers['err']

    def count(mask):
        return (valid & mask).sum(dim=1, dtype=torch.int32)

    is_reply = xid >= 0
    # zxid max over data replies only (masked frames contribute (0,0))
    zh = torch.where(valid & is_reply, headers['zxid_hi'], 0)
    zl = torch.where(valid & is_reply, headers['zxid_lo'], 0)
    mh, ml = u64pair_reduce_max(zh, zl, axis=1)

    return {
        'n_replies': count(is_reply),
        'n_notifications': count(xid == XID_NOTIFICATION),
        'n_pings': count(xid == XID_PING),
        'n_errors': count(is_reply & (err != 0)),
        'max_zxid_hi': mh,
        'max_zxid_lo': ml,
    }
