"""The comparison that decides ``correct``, shown to fail.

A whole run of each cell, its look for a chip skipped (the
ingest on the CPU, a fleet of 16), once sound and once with each fault
that the cell can have planted under the timed path (``faults.py``):
the control, which breaks the guarantee the configuration states; a
step that leaves its state unchanged; half of a batch left out; an
answer altered where it is produced.  One chip's cells have no
exchange between chips to leave out."""

import pytest

from zkbench import run

CASES = [
    ('ycsb-b-1024', None), ('ycsb-b-1024', 'stale_reads'),
    ('ycsb-b-1024', 'unchanged_state'), ('ycsb-b-1024', 'half_batch'),
    ('ycsb-b-1024', 'altered_answer'),
]


@pytest.mark.parametrize('cell,fault', CASES)
def test_correct_only_when_sound(cell, fault):
    res, checks = run.run_cell(cell, 2**31 + 101, 2.0, 0, device='cpu',
                               fault=fault, sessions=16, records=40,
                               grace_s=8.0)
    failed = {k: v for k, (v, lim) in checks.items() if v > lim}
    assert res['correct'] == (fault is None), failed
    assert res['correct'] == (not failed)
    assert list(res)[-2:] == ['checks', '_run']
