"""The port's EventEmitter and FSM base (the port of
tests/test_utils.py)."""

import asyncio

import pytest

from zkstream_tpu_torch.utils.events import EventEmitter
from zkstream_tpu_torch.utils.fsm import FSM


def test_emitter_on_emit_order():
    e = EventEmitter()
    got = []
    e.on('x', lambda v: got.append(('a', v)))
    e.on('x', lambda v: got.append(('b', v)))
    assert e.emit('x', 1) is True
    assert got == [('a', 1), ('b', 1)]


def test_emitter_once():
    e = EventEmitter()
    got = []
    e.once('x', got.append)
    e.emit('x', 1)
    e.emit('x', 2)
    assert got == [1]


def test_emitter_remove_listener_by_original_for_once():
    e = EventEmitter()
    got = []

    def cb(v):
        got.append(v)
    e.once('x', cb)
    e.remove_listener('x', cb)
    e.emit('x', 1)
    assert got == []


def test_emitter_listener_removed_mid_dispatch_is_skipped():
    e = EventEmitter()
    got = []

    def second(v):
        got.append('second')

    def first(v):
        got.append('first')
        e.remove_listener('x', second)
    e.on('x', first)
    e.on('x', second)
    e.emit('x', 1)
    assert got == ['first']


def test_emitter_no_listeners_returns_false():
    assert EventEmitter().emit('nope') is False


class Machine(FSM):
    def __init__(self):
        self.log = []
        super().__init__('a')

    def state_a(self, S):
        self.log.append('enter a')
        S.on(self, 'go', lambda: S.goto_state('b'))

    def state_b(self, S):
        self.log.append('enter b')
        S.on(self, 'go', lambda: S.goto_state('a'))
        S.on(self, 'sub', lambda: S.goto_state('b.inner'))

    def state_b_inner(self, S):
        self.log.append('enter b.inner')
        S.on(self, 'back', lambda: S.goto_state('b'))

def test_emitter_remove_all_listeners_one_event_and_all():
    e = EventEmitter()
    seen = []
    e.on('a', lambda: seen.append('a'))
    e.on('b', lambda: seen.append('b'))
    e.remove_all_listeners('a')
    assert e.emit('a') is False and e.emit('b') is True
    e.remove_all_listeners()
    assert e.emit('b') is False
    assert seen == ['b']


def test_emitter_listeners_introspection_is_a_copy():
    e = EventEmitter()

    def cb():
        pass
    e.on('x', cb)
    got = e.listeners('x')
    assert got == [cb] and e.listener_count('x') == 1
    got.clear()                      # mutating the copy changes nothing
    assert e.listener_count('x') == 1
    assert e.listeners('nope') == [] and e.listener_count('nope') == 0


def test_emitter_remove_unknown_listener_is_noop():
    e = EventEmitter()
    e.remove_listener('ghost', lambda: None)    # no such event

    def cb():
        pass

    def other():
        pass
    e.on('x', cb)
    e.remove_listener('x', other)               # not registered
    assert e.listener_count('x') == 1


def test_emitter_event_cleared_entirely_mid_dispatch():
    """A listener that removes EVERY listener for the event mid-emit:
    the dispatch loop sees the registry version change and the event
    gone, and stops without calling the rest."""
    e = EventEmitter()
    seen = []

    def nuke():
        seen.append('nuke')
        e.remove_all_listeners('x')

    e.on('x', nuke)
    e.on('x', lambda: seen.append('late'))
    assert e.emit('x') is True
    assert seen == ['nuke']


def test_emitter_listener_added_mid_dispatch_not_called_this_emit():
    e = EventEmitter()
    seen = []

    def adder():
        seen.append('adder')
        e.on('x', lambda: seen.append('new'))

    e.on('x', adder)
    e.on('x', lambda: seen.append('second'))
    e.emit('x')
    assert seen == ['adder', 'second']       # 'new' waits for next emit
    e.emit('x')
    assert seen.count('new') == 1


def test_fsm_basic_transitions():
    m = Machine()
    assert m.get_state() == 'a'
    m.emit('go')
    assert m.get_state() == 'b'
    m.emit('go')
    assert m.get_state() == 'a'


def test_fsm_old_state_listeners_disposed():
    m = Machine()
    m.emit('go')  # a -> b
    m.emit('go')  # b -> a (b's listeners disposed)
    m.emit('sub')  # 'sub' only valid in b: must be ignored in a
    assert m.get_state() == 'a'


def test_fsm_substate_inherits_parent_scope():
    m = Machine()
    m.emit('go')   # -> b
    m.emit('sub')  # -> b.inner
    assert m.get_state() == 'b.inner'
    assert m.is_in_state('b')
    assert m.is_in_state('b.inner')
    # Parent scope still live: 'go' (registered in b) still works.
    m.emit('go')
    assert m.get_state() == 'a'


def test_fsm_substate_back_to_parent_reenters():
    m = Machine()
    m.emit('go')
    m.emit('sub')
    m.log.clear()
    m.emit('back')
    assert m.get_state() == 'b'
    assert m.log == ['enter b']


def test_fsm_state_changed_event():
    m = Machine()
    seen = []
    m.on('stateChanged', seen.append)
    m.emit('go')
    m.emit('sub')
    assert seen == ['b', 'b.inner']


def test_fsm_synchronous_entry_transition():
    class Chain(FSM):
        def __init__(self):
            self.entered = []
            super().__init__('one')

        def state_one(self, S):
            self.entered.append('one')
            S.goto_state('two')

        def state_two(self, S):
            self.entered.append('two')

    c = Chain()
    assert c.get_state() == 'two'
    assert c.entered == ['one', 'two']


def test_fsm_scope_timers_cancelled_on_exit():
    async def run():
        class T(FSM):
            def __init__(self):
                self.fired = []
                super().__init__('x')

            def state_x(self, S):
                S.timeout(10, lambda: self.fired.append('x-timer'))
                S.on(self, 'go', lambda: S.goto_state('y'))

            def state_y(self, S):
                pass

        t = T()
        t.emit('go')
        await asyncio.sleep(0.05)
        assert t.fired == []

    asyncio.run(run())


def test_fsm_interval_fires_repeatedly_until_exit():
    async def run():
        class T(FSM):
            def __init__(self):
                self.count = 0
                super().__init__('x')

            def state_x(self, S):
                S.interval(10, self._tick)
                S.on(self, 'go', lambda: S.goto_state('y'))

            def _tick(self):
                self.count += 1

            def state_y(self, S):
                pass

        t = T()
        await asyncio.sleep(0.1)
        assert t.count >= 3
        t.emit('go')
        n = t.count
        await asyncio.sleep(0.05)
        assert t.count == n

    asyncio.run(run())


def test_fsm_unknown_state_raises():
    class Bad(FSM):
        def state_ok(self, S):
            S.on(self, 'go', lambda: S.goto_state('missing'))

    b = Bad('ok')
    with pytest.raises(AttributeError):
        b.emit('go')
