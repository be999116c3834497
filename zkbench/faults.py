"""Faults planted under a run, to show that the comparison catches them.

The benchmark's own runs plant nothing.  ``zkbench/tests`` and the
controls run on the chip (``python -m zkbench.run ... --fault NAME``)
plant one by patching the port's classes in the client process:

- ``stale_reads`` (the YCSB cells' control): ``Client.get`` answers
  from a client-side copy filled on a session's first read of a path
  and never invalidated, breaking the read guarantee the
  configuration states;
- ``unchanged_state``: ``Client.set`` acknowledges without sending,
  with the Stat the write would have had, so the state stays as it
  was;
- ``half_batch``: every other connection drops the replies the ingest
  decodes for it (its pings excepted), so half of each batch never
  reaches its session;
- ``altered_answer``: one byte of the data of every reply with data is
  changed as the receive path hands the decoded packet on.
"""

from __future__ import annotations

FAULTS = ('stale_reads', 'unchanged_state', 'half_batch', 'altered_answer')


def plant(name: str):
    """Plant fault ``name`` in this process; returns the function that
    takes it out again (the reads that judge a run are sound)."""
    if name not in FAULTS:
        raise ValueError('no fault %r (one of %s)' % (name, FAULTS))
    cls, attr, make = globals()['_' + name]()
    own = cls.__dict__.get(attr)
    setattr(cls, attr, make(getattr(cls, attr)))

    def undo():
        if own is None:
            delattr(cls, attr)
        else:
            setattr(cls, attr, own)
    return undo


def _stale_reads():
    from zkstream_tpu_torch import Client

    def make(get):
        async def cached_get(self, path, *a, **kw):
            copy = self.__dict__.setdefault('_zkbench_copy', {})
            if path not in copy:
                copy[path] = await get(self, path, *a, **kw)
            return copy[path]
        return cached_get
    return Client, 'get', make


def _unchanged_state():
    from zkstream_tpu_torch import Client

    def make(_set):
        async def unsent_set(self, path, data, version=-1, *a, **kw):
            _data, stat = await self.get(path)
            return stat._replace(version=stat.version + 1,
                                 mzxid=stat.mzxid + 1)
        return unsent_set
    return Client, 'set', make


def _half_batch():
    from zkstream_tpu_torch.io.connection import ZKConnection

    keep: dict = {}

    def make(process):
        def half_process(self, pkt):
            # every other connection never sees a reply (its pings do)
            if pkt['xid'] > 0 and not keep.setdefault(
                    id(self), len(keep) % 2 == 0):
                return None
            return process(self, pkt)
        return half_process
    return ZKConnection, 'process_reply', make


def _altered_answer():
    from zkstream_tpu_torch.io.connection import ZKConnection

    def make(emit):
        def altered_emit(self, evt, *args):
            # each decoded packet is emitted as 'packet' before it
            # settles its request: alter its data there, in place
            if evt == 'packet':
                data = args[0].get('data')
                if data:
                    args[0]['data'] = (bytes([data[0] ^ 1])
                                       + bytes(data[1:]))
            return emit(self, evt, *args)
        return altered_emit
    return ZKConnection, 'emit', make
