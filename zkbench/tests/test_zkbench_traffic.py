"""Each traffic module at a tiny size, driven directly against an
in-process port server with the ingest on the CPU, judged by the
reference; and the measuring entry, which without a card fails and
prints nothing."""

import asyncio
import os
import subprocess
import sys
import time

import pytest

from zkbench import spec
from zkbench.spec import ROOT


async def _drive(cell_name: str, seed: int, wal_dir: str) -> tuple:
    from zkstream_tpu_torch import Client
    from zkstream_tpu_torch.io.ingest import FleetIngest
    from zkstream_tpu_torch.server import ZKServer

    cell = spec.find_cell(cell_name)
    mix = spec.generator(cell.traffic).Mix(cell, seed, sessions=8,
                                           records=20)
    srv = await ZKServer(wal_dir=wal_dir, durability='tick').start()
    ingest = FleetIngest(device='cpu')
    clients = [Client(address='127.0.0.1', port=srv.port, ingest=ingest)
               for _ in range(mix.n_clients)]
    try:
        for c in clients:
            c.start()
        await asyncio.gather(*[c.wait_connected(timeout=30)
                               for c in clients])
        await mix.preload(clients)
        mix.start(clients)
        await asyncio.sleep(0.3)
        w0 = time.perf_counter()
        await asyncio.sleep(1.5)
        w1 = time.perf_counter()
        mix.stop(w1)
        await mix.drain(10)
        window = mix.window(w0, w1)
        readback = [await mix.readback(clients[0])]
    finally:
        await asyncio.gather(*[c.close() for c in clients])
        ingest.close()
        await srv.stop()
    return mix, window, readback


#: each mix as its cell runs it
CELLS = ['ycsb-b-1024']


@pytest.mark.parametrize('cell', CELLS)
def test_traffic_module_against_the_reference(cell, tmp_path):
    from zkstream_tpu_torch.server.persist import recover_state

    mix, window, readback = asyncio.run(_drive(cell, 2**31 + 3,
                                               str(tmp_path)))
    recovered = [mix.recovered(recover_state(str(tmp_path)).nodes)]
    checks = mix.check(readback, recovered)
    assert window['attempted'] > 0 and window['failed'] == 0
    assert {k: v for k, (v, _lim) in checks.items() if v} == {}
    # every session of the fleet works, each a closed loop
    assert set(mix.log.rows().session) == set(range(mix.n_clients))


def test_the_entry_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    res = subprocess.run(
        [sys.executable, '-m', 'zkbench.run', '--workload', 'ycsb-b-1024',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert res.stdout == ''
    assert 'CUDA device' in res.stderr
