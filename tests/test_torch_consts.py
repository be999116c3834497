"""Protocol-constant table checks of the port (reference:
lib/zk-consts.js): the port of tests/test_consts.py.  Each table is also
held to the JAX package's, name for name and value for value."""

from zkstream_tpu.protocol import consts as ref
from zkstream_tpu_torch.protocol import consts
from zkstream_tpu_torch.protocol.consts import (
    CreateFlag,
    ErrCode,
    KeeperState,
    NotificationType,
    OpCode,
    Perm,
    err_name,
    op_name,
)


def _table(enum) -> dict:
    return {m.name: int(m) for m in enum}


def test_opcode_values():
    assert OpCode.NOTIFICATION == 0
    assert OpCode.CREATE == 1
    assert OpCode.DELETE == 2
    assert OpCode.EXISTS == 3
    assert OpCode.GET_DATA == 4
    assert OpCode.SET_DATA == 5
    assert OpCode.GET_ACL == 6
    assert OpCode.SET_ACL == 7
    assert OpCode.GET_CHILDREN == 8
    assert OpCode.SYNC == 9
    assert OpCode.PING == 11
    assert OpCode.GET_CHILDREN2 == 12
    assert OpCode.CHECK == 13
    assert OpCode.MULTI == 14
    assert OpCode.AUTH == 100
    assert OpCode.SET_WATCHES == 101
    assert OpCode.SASL == 102
    assert OpCode.CREATE_SESSION == -10
    assert OpCode.CLOSE_SESSION == -11
    assert _table(OpCode) == _table(ref.OpCode)


def test_opcode_reverse_lookup():
    assert op_name(8) == 'GET_CHILDREN'
    assert op_name(-11) == 'CLOSE_SESSION'
    for code in _table(ref.OpCode).values():
        assert op_name(code) == ref.op_name(code)


def test_err_codes():
    assert ErrCode.OK == 0
    assert ErrCode.CONNECTION_LOSS == -4
    assert ErrCode.NO_NODE == -101
    assert ErrCode.BAD_VERSION == -103
    assert ErrCode.NO_CHILDREN_FOR_EPHEMERALS == -108
    assert ErrCode.NODE_EXISTS == -110
    assert ErrCode.NOT_EMPTY == -111
    assert ErrCode.SESSION_EXPIRED == -112
    assert ErrCode.AUTH_FAILED == -115
    assert _table(ErrCode) == _table(ref.ErrCode)


def test_err_reverse_lookup_and_unknown():
    assert err_name(-101) == 'NO_NODE'
    assert err_name(0) == 'OK'
    # Unknown codes must not crash the decoder.
    assert err_name(-9999) == 'ERROR_-9999'
    for code in list(_table(ref.ErrCode).values()) + [-9999, 5]:
        assert err_name(code) == ref.err_name(code)


def test_err_text_covers_all_nonzero_codes():
    for code in ErrCode:
        if code != ErrCode.OK:
            assert code.name in consts.ERR_TEXT
    assert consts.ERR_TEXT == ref.ERR_TEXT


def test_perm_masks():
    assert Perm.READ == 1
    assert Perm.WRITE == 2
    assert Perm.CREATE == 4
    assert Perm.DELETE == 8
    assert Perm.ADMIN == 16
    assert Perm.ALL == 31
    assert _table(Perm) == _table(ref.Perm)


def test_create_flags():
    assert CreateFlag.EPHEMERAL == 1
    assert CreateFlag.SEQUENTIAL == 2
    assert CreateFlag.EPHEMERAL | CreateFlag.SEQUENTIAL == 3
    assert _table(CreateFlag) == _table(ref.CreateFlag)


def test_notification_types():
    assert NotificationType.CREATED == 1
    assert NotificationType.DELETED == 2
    assert NotificationType.DATA_CHANGED == 3
    assert NotificationType.CHILDREN_CHANGED == 4
    assert _table(NotificationType) == _table(ref.NotificationType)


def test_keeper_states():
    assert KeeperState.SYNC_CONNECTED == 3
    assert KeeperState.EXPIRED == -122
    assert KeeperState.DISCONNECTED == 0
    assert _table(KeeperState) == _table(ref.KeeperState)


def test_special_xids():
    assert consts.XID_NOTIFICATION == -1
    assert consts.XID_PING == -2
    assert consts.XID_AUTHENTICATION == -4
    assert consts.XID_SET_WATCHES == -8
    assert consts.SPECIAL_XIDS[-1] == 'NOTIFICATION'
    assert consts.SPECIAL_XIDS[-2] == 'PING'
    assert consts.SPECIAL_XIDS[-8] == 'SET_WATCHES'
    assert consts.SPECIAL_XIDS == ref.SPECIAL_XIDS


def test_max_packet():
    assert consts.MAX_PACKET == 16 * 1024 * 1024
    assert consts.MAX_PACKET == ref.MAX_PACKET
