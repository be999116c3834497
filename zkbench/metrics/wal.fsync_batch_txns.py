"""``wal.fsync_batch_txns``: transactions a group fsync of the leader's
write-ahead log covered in the window: the change of ``mntr``'s
``zk_wal_last_index`` over the change of ``zk_wal_fsyncs``."""


def read(ctx):
    w = ctx.wal
    if not w or not w['fsyncs']:
        return None
    return w['appends'] / w['fsyncs']
