"""Two processes x 4 CPU shards over one gloo process group.

Each worker process (this file run as a script; it imports no JAX)
joins the group with ``parallel.initialize``, builds a mesh over 4 CPU
shards — 8 global dp shards, rank-major — and either

- ``globals``: decodes its half of a seeded fleet with
  ``sharded_wire_step`` (rows placed by ``host_local_wire_batch``) and
  prints the replicated fleet-global stats, which the parent holds
  against the JAX package's single-device reduction of the whole fleet;
- ``fleet``: serves its own stand-in connections through one
  ``MultihostFleetIngest``, stops at a coordinated tick count and
  prints its launch/tick counts and the fleet max zxid, which must
  agree across the processes and equal the larger of their own maxima.

No process group is created inside the pytest process: pytest-xdist
reuses its workers, so the groups live only in the spawned processes.

On a machine with four cards, ``_run(mode, cuda=True)`` runs the same
workers over NCCL, each process's 4 shards on two cards of its own (no
test calls it: the tests run without a card).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, F = 16, 256, 8        # the globals fleet: 8 rows a process
STOP_AT = 60                # the fleet run's coordinated tick count


def _fleet(seed=10):
    """The seeded reply fleet both processes cut their rows from."""
    import random
    import struct

    import numpy as np

    rng = random.Random(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros((B,), np.int32)
    for i in range(B):
        s = b''
        for _ in range(rng.randrange(0, 6)):
            xid = rng.choice([-1, rng.randrange(1, 1000)])
            zxid = rng.randrange(0, 1 << 63) if xid >= 0 else -1
            hdr = struct.pack('>iqi', xid, zxid, rng.choice([0, -101]))
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(20)))
            s += struct.pack('>i', len(hdr) + len(body)) + hdr + body
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


def _worker_globals(rank: int, devices: list) -> dict:
    from zkstream_tpu_torch.ops.bytesops import u64pair_reduce_max
    from zkstream_tpu_torch.ops.pipeline import (batch_to_device,
                                                 wire_pipeline_step_auto)
    from zkstream_tpu_torch.parallel import (host_local_wire_batch,
                                             make_mesh, sharded_wire_step)

    mesh = make_mesh(dp=8, devices=devices)
    assert mesh.shape == {'dp': 8, 'sp': 1} and mesh.world_size == 2
    buf, lens = _fleet()
    half = slice(rank * (B // 2), (rank + 1) * (B // 2))
    stats, g = sharded_wire_step(mesh, max_frames=F)(
        *host_local_wire_batch(mesh, buf[half], lens[half]))
    # the port's single-device step over the whole fleet, for reference
    ref = wire_pipeline_step_auto(*batch_to_device(buf, lens, devices[0]),
                                  max_frames=F)
    rh, rl = u64pair_reduce_max(ref.max_zxid_hi, ref.max_zxid_lo)
    return {'globals': [int(x) for x in g],
            'reference': [int(ref.n_frames.sum()),
                          int(ref.n_notifications.sum()),
                          int(ref.n_errors.sum()), int(rh), int(rl)],
            'n_frames': stats.n_frames.tolist()}


def _worker_fleet(rank: int, devices: list) -> dict:
    import asyncio

    from zkstream_tpu_torch import corpus
    from zkstream_tpu_torch.parallel import MultihostFleetIngest, make_mesh
    from zkstream_tpu_torch.protocol.framing import PacketCodec

    class Conn:
        def __init__(self, xid_map):
            self.codec = PacketCodec(use_native=False)
            self.codec.handshaking = False
            self.codec.xid_map.update(xid_map)
            self.got, self.err = [], None

        def is_in_state(self, state):
            return state == 'connected' and self.err is None

        def emit(self, _event, pkts, err):
            self.got += pkts
            self.err = err or self.err

    buf, _lens, _slots, maps = corpus.fleet(B=4, seed=20 + rank, frames=16)
    streams = [r.tobytes() for r in buf]
    want = [Conn(m).codec.decode(s) for s, m in zip(streams, maps)]
    conns = [Conn(m) for m in maps]
    proxy = MultihostFleetIngest(
        mesh=make_mesh(dp=8, devices=devices),
        local_rows=4, stream_len=4096, tick_interval=0.01,
        body_mode='host', max_frames=4)

    async def run():
        proxy.warmup_tick()
        proxy.start()
        for c in conns:
            proxy.register(c)
        for k in range(3):
            for c, s in zip(conns, streams):
                proxy.feed(c, s[k * len(s) // 3:(k + 1) * len(s) // 3])
            await asyncio.sleep(0.02)
        while any(b for _c, b in proxy._slots.values()):
            await asyncio.sleep(0.01)
        assert proxy.tick_count < STOP_AT, proxy.tick_count
        await proxy.stop(after_ticks=STOP_AT)

    asyncio.run(run())
    assert all(c.err is None and c.got == w for c, w in zip(conns, want))
    local = max(p['zxid'] for c in conns for p in c.got if p['xid'] >= 0)
    return {'launches': proxy.launch_count, 'ticks': proxy.tick_count,
            'device_ticks': proxy.ticks, 'local_max': local,
            'fleet_max': proxy.fleet_max_zxid}


def _main(mode: str, rank: int, world: int, addr: str,
          cuda: bool = False) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from zkstream_tpu_torch.parallel import initialize

    if cuda:                 # 4 shards on two cards of this process
        torch.cuda.set_device(2 * rank)
        devices = [torch.device('cuda', 2 * rank + k % 2) for k in range(4)]
    else:
        devices = [torch.device('cpu')] * 4
    initialize(addr, num_processes=world, process_id=rank)
    assert dist.get_backend() == ('nccl' if cuda else 'gloo')
    try:
        out = (_worker_globals if mode == 'globals' else _worker_fleet)(
            rank, devices)
    finally:
        dist.destroy_process_group()
    assert not any(m == 'jax' or m.startswith(('jax.', 'zkstream_tpu.'))
                   or m == 'zkstream_tpu' for m in sys.modules)
    print('WORKER_OK %d %s' % (rank, json.dumps(out)), flush=True)
    return 0


def _run(mode: str, timeout: float = 120.0, cuda: bool = False) -> list:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        addr = '127.0.0.1:%d' % s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), '2', addr]
        + (['cuda'] if cuda else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, 'worker %d (rc %s):\n%s' % (
            r, p.returncode, out[-3000:])
        line = next(ln for ln in out.splitlines()
                    if ln.startswith('WORKER_OK %d ' % r))
        res.append(json.loads(line.split(' ', 2)[2]))
    return res


def test_two_process_globals_match_jax_reduction():
    import jax.numpy as jnp
    import numpy as np

    from zkstream_tpu.ops.bytesops import u64pair_reduce_max
    from zkstream_tpu.ops.pipeline import wire_pipeline_step

    res = _run('globals')
    buf, lens = _fleet()
    ref = wire_pipeline_step(jnp.asarray(buf), jnp.asarray(lens),
                             max_frames=F)
    rh, rl = u64pair_reduce_max(ref.max_zxid_hi, ref.max_zxid_lo)
    want = [int(np.sum(ref.n_frames)), int(np.sum(ref.n_notifications)),
            int(np.sum(ref.n_errors)), int(rh), int(rl)]
    assert res[0]['globals'] == res[1]['globals'] == want
    assert res[0]['reference'] == res[1]['reference'] == want
    assert want[0] > 0
    assert res[0]['n_frames'] + res[1]['n_frames'] == \
        np.asarray(ref.n_frames).tolist()


def test_two_process_multihost_fleet_keeps_launches_aligned():
    res = _run('fleet')
    for r in res:
        assert r['launches'] == r['ticks'] == STOP_AT
        assert r['device_ticks'] > 0
    assert res[0]['fleet_max'] == res[1]['fleet_max'] == \
        max(r['local_max'] for r in res)


if __name__ == '__main__':
    sys.exit(_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4], cuda=sys.argv[5:] == ['cuda']))
