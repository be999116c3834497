"""The chunk walk of the sequence-parallel frame scan, on an H100.

``parallel/seqscan.py`` cuts one long stream's byte axis into chunks
and hands the frame cursor from chunk to chunk around a ring.  A chunk,
once it learns its entry cursor, walks its frames until the cursor
passes its end; that walk is this module.  It replaces the XLA
``while_loop`` of ``zkstream_tpu/parallel/seqscan.py::_walk``, which is
not a Pallas kernel.  The CUDA C++ source is the chunk-walk section of
``zkstream_tpu_torch/csrc/wire_scan.cu``, built with kernels K1 and K2
into one library.

What bounds it on an H100: latency.  Where a frame starts depends on
the length of the one before it, so a walk that follows the frames one
by one makes one dependent memory round trip a frame, and all of it
sits on the ring's critical path once the entry is known.  The design
moves almost all of that work to before the entry is known and makes
it parallel, in three kernels:

1. :func:`seq_walk_prepare` (``seq_prepare_kernel``, one launch a
   chunk, before the ring's first step, so all chunks build theirs at
   once): the chunk is cut into tiles of ``tile`` bytes, one block a
   tile in shared memory, and every offset gets its *exit*: where
   ``_walk`` started there would first reach the tile's stop
   (``min(tile end, chunk_end)``), or end for want of a prefix or at
   ``chunk_end`` (that cursor), or go bad (:data:`EXIT_BAD`) or meet a
   truncated frame (:data:`EXIT_STOPPED`).  Pointer doubling in shared
   memory finds it in about ``log2(tile / 4)`` rounds.  The map is int32
   ``[C]``: four bytes of device memory for each byte of the stream
   (65 MB for a 16.2 MB stream), held in :class:`WalkState`.
2. :func:`seq_walk` (``seq_hop_kernel`` then ``seq_mark_kernel``, one
   call a ring step): the hop kernel adopts the offered entry on the
   device, as before, and follows ``q <- exits[q - base]``, one
   dependent read a tile (a frame longer than a tile skips tiles in one
   hop), recording each visited tile's first frame in ``tile_entry``;
   the mark kernel, one block a tile, walks each visited tile's frames
   in shared memory and writes the tile's mask bytes.

The stream's valid length ``n`` reaches the kernels as an int32 on the
device, and each computes the chunk's end ``min(base + C, n)`` from
it, as the JAX scan traces ``n``: one launch sequence, and so one
captured scan program (``parallel/seqscan.py``), serves every ``n`` of
a stream length.

Each call to :func:`seq_walk` on a card is two launches (both counted
in :data:`launches`); each :func:`seq_walk_prepare` one (counted in
:data:`prepare_launches`), through ``tick_graph.count_launch``, so a
replayed scan counts the launches it holds.  A walk on a card whose
state was not prepared for the same chunk raises: nothing falls back to
a serial walk.  On the CPU, :func:`seq_walk` runs :func:`seq_walk_plain`,
which needs no map, so :func:`seq_walk_prepare` only records the chunk;
the plain versions of the three steps (:func:`tile_exits_plain`,
:func:`hop_plain`, :func:`mark_plain`) compose into
:func:`tiled_walk_plain`, which the tests hold to ``_walk``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..protocol.consts import MAX_PACKET
from . import wire_scan
from .tick_graph import count_launch

#: What this kernel replaces: an XLA while_loop, not a Pallas kernel.
REPLACES = 'zkstream_tpu/parallel/seqscan.py:41'

#: The exit cursor of a walk that hit a bad or truncated frame.
SATURATED = 1 << 30

#: Exit-map values of an offset whose walk meets a bad length prefix or a
#: truncated frame before the tile's stop.
EXIT_BAD = -1
EXIT_STOPPED = -2

#: Tile sizes: powers of two, local offsets fit the kernel's uint16.
MIN_TILE, MAX_TILE = 1 << 3, 1 << 16
#: The tile of :func:`new_state`: on an H100 the lowest sum of the sp=1
#: and sp=4 scans' device times (PERF.md section 6).
DEFAULT_TILE = 1 << 15

#: Kernel launches since the last reset (the plain versions never
#: count): the walk's two a call, and the exit map's one.
launches = 0
prepare_launches = 0

_bound = None


@dataclass(eq=False)
class WalkState:
    """One chunk's ring state.  :func:`seq_walk_prepare` fills
    ``exits`` and :func:`seq_walk` updates the rest in place."""

    valid: torch.Tensor       # int32 0-d: 1 once the chunk has walked
    exit: torch.Tensor        # int32 0-d: exit cursor (-1 before the walk)
    mask: torch.Tensor        # bool [C]: frame-start mask of the chunk
    bad: torch.Tensor         # bool 0-d: a bad length prefix was seen
    exits: torch.Tensor       # int32 [C]: the tile exit map
    tile_entry: torch.Tensor  # int32 [tiles + 1]: each visited tile's
    #                           first frame (-1 elsewhere); the last slot
    #                           says whether the last call walked
    tile: int                 # bytes a tile
    prepared: tuple | None = None  # (ext pointer, base)


def _tile_shift(tile: int) -> int:
    if tile < MIN_TILE or tile > MAX_TILE or tile & (tile - 1):
        raise ValueError('tile must be a power of two in [%d, %d], got %r'
                         % (MIN_TILE, MAX_TILE, tile))
    return tile.bit_length() - 1


def new_state(C: int, device, tile: int = DEFAULT_TILE) -> WalkState:
    """The zero state: not walked, exit -1, empty mask, not bad, no exit
    map yet."""
    _tile_shift(tile)
    return WalkState(
        valid=torch.zeros((), dtype=torch.int32, device=device),
        exit=torch.full((), -1, dtype=torch.int32, device=device),
        mask=torch.zeros((C,), dtype=torch.bool, device=device),
        bad=torch.zeros((), dtype=torch.bool, device=device),
        exits=torch.empty((C,), dtype=torch.int32, device=device),
        tile_entry=torch.zeros((-(-C // tile) + 1,), dtype=torch.int32,
                               device=device),
        tile=tile)


def load():
    """Build (if needed) the kernel library and bind the chunk walk's
    launchers; idempotent."""
    global _bound
    lib = wire_scan.load()
    if _bound is None:
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        prep, hop, mark = (lib.seq_prepare_launch, lib.seq_hop_launch,
                           lib.seq_mark_launch)
        prep.argtypes = [P, LL, I, LL, P, P, P]
        hop.argtypes = [P, LL, I, LL] + [P] * 8
        mark.argtypes = [P, LL, I, LL, P, P, P, P]
        geo = lib.seq_walk_geometry
        geo.argtypes = [I] + [ctypes.POINTER(I)] * 5
        for fn in (prep, hop, mark, geo):
            fn.restype = I
        _bound = (prep, hop, mark, geo)
    return lib


def launch_config(C: int, tile: int = DEFAULT_TILE) -> dict:
    """The three kernels' geometry for a chunk of ``C`` bytes (needs the
    library): grids, threads and dynamic shared memory."""
    load()
    out = [ctypes.c_int() for _ in range(5)]
    rc = _bound[3](_tile_shift(tile), *(ctypes.byref(v) for v in out))
    if rc != 0:
        raise RuntimeError('seq_walk_geometry failed: cudaError %d' % (rc,))
    ps, pt, ms, mt, ht = (v.value for v in out)
    tiles = -(-C // tile)
    return {'tile': tile, 'tiles': tiles,
            'prepare': {'blocks': tiles, 'threads': pt, 'smem_bytes': ps},
            'hop': {'blocks': 1, 'threads': ht, 'smem_bytes': 0},
            'mark': {'blocks': tiles, 'threads': mt, 'smem_bytes': ms}}


def _word(raw: bytes, rel: int) -> int:
    """The big-endian int32 at chunk offset ``rel``, each byte clamped to
    ``[0, len(raw) - 1]``."""
    E = len(raw)
    if 0 <= rel and rel + 4 <= E:
        return int.from_bytes(raw[rel:rel + 4], 'big', signed=True)
    return int.from_bytes(bytes(raw[min(max(rel + k, 0), E - 1)]
                                for k in range(4)), 'big', signed=True)


def _bool_mask(mask: bytearray) -> torch.Tensor:
    """A bool tensor, copied from a bytearray of 0 and 1 bytes."""
    if not mask:
        return torch.zeros((0,), dtype=torch.bool)
    return torch.frombuffer(mask, dtype=torch.uint8).bool()


def walk_plain(ext, base: int, chunk_end: int, n: int, entry: int):
    """The plain walk, ``_walk``'s semantics, for a CPU tensor: walk
    frames from absolute cursor ``entry`` until past ``chunk_end`` (or
    the stream ends or goes bad).  ``ext`` is the chunk plus a 4-byte
    right halo.  Returns ``(exit cursor, bool mask [C], bad)``."""
    C = ext.shape[0] - 4
    raw = ext.numpy().tobytes()
    mask = bytearray(C)
    q, bad, stop = entry, False, False
    while not stop and not bad and q < chunk_end and q + 4 <= n:
        lq = q - base
        ln = _word(raw, lq)
        is_bad = ln < 0 or ln > MAX_PACKET
        complete = not is_bad and q + 4 + ln <= n
        if complete and 0 <= lq < C:
            mask[lq] = 1
        if complete:
            q += 4 + ln
        bad = bad or is_bad
        stop = not complete
    # a bad prefix or truncated frame ends the whole stream's decode
    if bad or stop:
        q = SATURATED
    return q, _bool_mask(mask), bad


def tile_exits_plain(ext, base: int, chunk_end: int, n: int,
                     tile: int) -> torch.Tensor:
    """The exit map, plain torch on ``ext``'s device: int32 ``[C]``, for
    each chunk offset the first cursor at or past its tile's stop
    ``min(tile end, chunk_end)`` that ``_walk`` started there reaches,
    the cursor where that walk ends (at or past ``chunk_end``, or with
    no room for a prefix), :data:`EXIT_BAD` or :data:`EXIT_STOPPED`.
    Pointer doubling over the whole chunk at once."""
    _tile_shift(tile)
    C = ext.shape[0] - 4
    s = torch.arange(C, dtype=torch.int64, device=ext.device)
    b = ext.to(torch.int64)
    ln = (b[:C] << 24) | (b[1:C + 1] << 16) | (b[2:C + 2] << 8) | b[3:C + 3]
    ln = torch.where(ln >= 2**31, ln - 2**32, ln)
    q = base + s
    stop = torch.clamp(base + (s // tile + 1) * tile, max=chunk_end)
    term = (q >= chunk_end) | (q + 4 > n)
    is_bad = ~term & ((ln < 0) | (ln > MAX_PACKET))
    succ = q + 4 + ln
    trunc = ~term & ~is_bad & (succ > n)
    inner = ~term & ~is_bad & ~trunc & (succ < stop)
    val = torch.where(term, q, torch.where(
        is_bad, EXIT_BAD, torch.where(trunc, EXIT_STOPPED, succ)))
    ptr = torch.where(inner, succ - base, s)
    act = inner.nonzero().flatten()       # offsets not yet at their end
    while act.numel():
        p = ptr[act]
        pp = ptr[p]
        moved = pp != p
        act = act[moved]
        ptr[act] = pp[moved]
    return val[ptr].to(torch.int32)


def hop_plain(exits, ext, base: int, chunk_end: int, n: int, entry: int,
              tile: int):
    """The hop chain, plain: from ``entry`` follow the exit map
    ``exits`` (CPU int32 ``[C]``), with ``_walk``'s steps while the
    cursor is before the chunk.  Returns ``(exit cursor, bad,
    tile_entry)``: int32 ``[tiles]``, each visited tile's first frame
    offset, -1 elsewhere."""
    C = ext.shape[0] - 4
    raw = ext.numpy().tobytes()
    tile_entry = [-1] * -(-C // tile)
    q, bad, stop = entry, False, False
    while not stop and not bad and q < chunk_end and q + 4 <= n:
        if q >= base:
            s = q - base
            tile_entry[s // tile] = s
            e = int(exits[s])
            bad, stop = e == EXIT_BAD, e == EXIT_STOPPED
            q = q if bad or stop else e
        else:
            ln = _word(raw, q - base)
            bad = ln < 0 or ln > MAX_PACKET
            stop = not bad and q + 4 + ln > n
            q = q if bad or stop else q + 4 + ln
    if bad or stop:
        q = SATURATED
    return q, bad, torch.tensor(tile_entry, dtype=torch.int32)


def mark_plain(ext, base: int, chunk_end: int, n: int, tile_entry,
               tile: int) -> torch.Tensor:
    """The mark, plain: each visited tile's frames from its first frame
    up to its stop.  Returns the bool mask ``[C]``."""
    C = ext.shape[0] - 4
    raw = ext.numpy().tobytes()
    mask = bytearray(C)
    for t, s0 in enumerate(tile_entry.tolist()):
        if s0 < 0:
            continue
        q, stop = base + s0, min(base + (t + 1) * tile, chunk_end)
        while q < stop and q + 4 <= n:
            i = q - base
            ln = int.from_bytes(raw[i:i + 4], 'big', signed=True)
            if ln < 0 or ln > MAX_PACKET or q + 4 + ln > n:
                break
            mask[i] = 1
            q += 4 + ln
    return _bool_mask(mask)


def tiled_walk_plain(ext, base: int, chunk_end: int, n: int, entry: int,
                     tile: int):
    """The three steps composed, plain: :func:`tile_exits_plain`, then
    :func:`hop_plain`, then :func:`mark_plain`.  Returns what
    :func:`walk_plain` returns."""
    exits = tile_exits_plain(ext, base, chunk_end, n, tile)
    q, bad, tile_entry = hop_plain(exits, ext, base, chunk_end, n, entry,
                                   tile)
    return q, mark_plain(ext, base, chunk_end, n, tile_entry, tile), bad


def seq_walk_plain(ext, base: int, n, rcv, state: WalkState) -> None:
    """One ring step of one chunk, plain: adopt the offered entry
    ``rcv`` (int32 0-d) and walk to ``min(base + C, n)``, unless the
    chunk walked already or no entry was offered (``rcv < 0``).  ``n``
    is an int or an int32 0-d tensor."""
    entry = int(rcv)
    if int(state.valid) or entry < 0:
        return
    n = int(n)
    chunk_end = min(base + ext.shape[0] - 4, n)
    q, mask, bad = walk_plain(ext, base, chunk_end, n, entry)
    state.valid.fill_(1)
    state.exit.fill_(q)
    state.mask.copy_(mask)
    state.bad.fill_(bad)


def _check(ext, base, n, state) -> None:
    """Shapes, devices and cursors.  ``n`` is an int (a CPU walk) or an
    int32 0-d tensor on ``ext``'s device (a card's walk takes only
    that, and reads it on the device alone)."""
    if ext.dtype != torch.uint8 or ext.dim() != 1 or ext.shape[0] < 5:
        raise ValueError('ext must be uint8 [C + 4] with C >= 1, got %s %s'
                         % (ext.dtype, tuple(ext.shape)))
    C = ext.shape[0] - 4
    if state.mask.shape != (C,) or state.mask.dtype != torch.bool:
        raise ValueError('state.mask must be bool [%d]' % C)
    for t in (state.valid, state.exit, state.mask, state.bad, state.exits,
              state.tile_entry):
        if t.device != ext.device:
            raise ValueError('the chunk walk\'s tensors must share a device')
    if isinstance(n, torch.Tensor):
        if n.dtype != torch.int32 or n.numel() != 1 \
                or n.device != ext.device:
            raise ValueError('n must be one int32 on ext\'s device')
    elif ext.device.type != 'cpu':
        raise ValueError('a walk on a card reads n from the device: pass '
                         'an int32 0-d tensor')
    elif not 0 <= n <= 2**31 - 1:
        raise ValueError('n must lie in [0, 2^31)')
    if not 0 <= base or base + C + 4 > 2**31 - 1:
        raise ValueError('cursors must lie in [0, 2^31): base + C + 4 '
                         'must be below 2^31')


def _device(ext) -> None:
    if ext.device.type != 'cuda':
        raise ValueError('the chunk walk runs on CUDA or CPU tensors, not %s'
                         % (ext.device,))
    if not ext.is_contiguous():
        raise ValueError('the chunk walk needs a contiguous ext')


def seq_walk_prepare(ext, base: int, n, state: WalkState) -> None:
    """Build the chunk's exit map into ``state.exits`` with the kernel,
    on the current stream, for the chunk ``[base, base + C)`` of a
    stream of ``n`` valid bytes (on a card an int32 0-d tensor on
    ``ext``'s device, which the kernel reads there); for a CPU tensor
    only record the chunk (the CPU walk, :func:`seq_walk_plain`, reads
    no map).  It does not depend on the entry, so every chunk prepares
    before the ring."""
    _check(ext, base, n, state)
    if ext.device.type != 'cpu':
        _device(ext)
        load()
        with torch.cuda.device(ext.device):
            rc = _bound[0](ext.data_ptr(), ext.shape[0] - 4,
                           _tile_shift(state.tile), base, n.data_ptr(),
                           state.exits.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError('exit map launch failed: cudaError %d'
                               % (rc,))
        count_launch(__name__, 'prepare_launches')
    state.prepared = (ext.data_ptr(), base)


def seq_walk(ext, base: int, n, rcv, state: WalkState) -> None:
    """One ring step of one chunk of a stream of ``n`` valid bytes (as
    for :func:`seq_walk_prepare`): a CPU tensor runs
    :func:`seq_walk_plain`; a CUDA tensor launches the hop and the mark
    kernels on the current stream, which read ``n``, ``rcv`` and
    ``state.valid`` on the device and update ``state`` there.  On a card
    the state must have been prepared (:func:`seq_walk_prepare`) for
    this ``ext`` and ``base``."""
    _check(ext, base, n, state)
    if rcv.dtype != torch.int32 or rcv.numel() != 1 \
            or rcv.device != ext.device:
        raise ValueError('rcv must be one int32 cursor on ext\'s device')
    if ext.device.type == 'cpu':
        seq_walk_plain(ext, base, n, rcv, state)
        return
    _device(ext)
    if state.prepared != (ext.data_ptr(), base):
        raise RuntimeError('the chunk walk\'s state was not prepared for '
                           'this chunk: call seq_walk_prepare first')
    load()
    prep, hop, mark, _geo = _bound
    C, shift = ext.shape[0] - 4, _tile_shift(state.tile)
    with torch.cuda.device(ext.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = hop(ext.data_ptr(), C, shift, base, n.data_ptr(),
                 state.exits.data_ptr(), rcv.data_ptr(),
                 state.valid.data_ptr(), state.exit.data_ptr(),
                 state.bad.data_ptr(), state.tile_entry.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError('chunk walk hop launch failed: cudaError %d'
                               % (rc,))
        count_launch(__name__)
        rc = mark(ext.data_ptr(), C, shift, base, n.data_ptr(),
                  state.tile_entry.data_ptr(), state.mask.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError('chunk walk mark launch failed: cudaError %d'
                               % (rc,))
        count_launch(__name__)


def bound_bytes(C: int, frames: int) -> int:
    """Bytes a chunk's walk must move at least: the 4-byte prefix of
    each of the ``frames`` frames it finds, the entry read, and the
    mask, exit, flag and bad written.  The bound of the function,
    whatever the design."""
    return 4 * frames + 4 + C + 9


def stream_bound_bytes(C: int) -> int:
    """Bytes this design's walk moves at least: it reads the whole chunk
    and its halo into shared memory (the mark kernel), so its floor is
    the chunk read once where :func:`bound_bytes` reads only the
    prefixes."""
    return (C + 4) + 4 + C + 9


def prepare_bound_bytes(C: int) -> int:
    """Bytes :func:`seq_walk_prepare` must move: the chunk and its halo
    read once, the int32 exit map written once."""
    return (C + 4) + 4 * C
