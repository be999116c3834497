// K1 and K2: the frame walk of a fleet of reply streams, on an H100.
//
// K1 (wire_scan_kernel) replaces zkstream_tpu/ops/pallas_scan.py::_kernel
// (launched by pallas_wire_scan).  K2 (full_scan_kernel) replaces
// pallas_scan.py::_full_kernel (launched by pallas_wire_full_scan): K1's
// walk plus the GET_DATA body in the same pass.  Both call one frame step,
// next_frame(), a template over where the bytes come from, so their frame
// state machines cannot diverge (the Pallas kernels share _scan_frame for
// the same reason).
//
// The walk, per stream row, for up to max_frames steps: read the
// big-endian int32 length at cur; a length < 0 or > MAX_PACKET sets a
// sticky `bad`.  The frame is complete if cur+4+len <= n: emit
// start = cur+4 (else -1) and size = len (else 0).  If also len >= 16
// (hdr_ok), read xid (+4), zxid hi (+8), zxid lo (+12) and err (+16)
// (else 0).  After the walk write resid (the final cursor), bad and the
// count of complete frames.  This is what the plain versions
// ops/frame_scan.py::frame_cursor_scan + ops/headers.py::parse_reply_headers
// compute.
//
// K2 adds, per hdr_ok frame (0 elsewhere):
//   dlen     the raw big-endian int32 at cur+20 (the jute buffer length);
//   nb       clamp(dlen, 0, MAX_PACKET+1), before any extent arithmetic;
//   data[w]  the big-endian word at cur+24+4w where 4w < nb, w < DW;
//   stat[k]  the big-endian word at cur+24+nb+4k, k < 17, where the Stat
//            fits the frame (20+nb+68 <= len).
// That is ops/full_scan.py::full_scan_plain.  Byte masking of the data
// words and the extent rules stay elementwise torch (ops/pipeline.py).
//
// Every byte read at an offset past L-1 reads byte L-1, as the plain
// version's _byte_at clamps it, so lens > L rows agree.  Row offsets are
// 32-bit unsigned: lens is int32, so a cursor is below 2^31, and a length
// is at most MAX_PACKET = 2^24 before it is added, so no extent wraps (the
// wrappers take rows of at most INT32_MAX bytes).  Once a step completes
// no frame no later step can, so the walk writes the empty tail and stops.
//
// What bounds them on an H100.  Both must move little: K1 20 bytes a frame
// read and 24 a frame slot written, K2 most of every row read and 352
// bytes a slot written (at max_data 256).  But a frame's length says where
// the next frame starts, so a row's walk is a chain of dependent reads.
// K1 reads only the 20 bytes at each frame's head (about 8% of the row),
// so it cannot afford to stream the row: it makes one device-memory round
// trip per frame, 64 in a row of the corpus, each for one or two 32-byte
// sectors scattered over the whole batch.  With every row of a tick in
// flight, what sets its time is how fast device memory serves such
// scattered sectors (fetching fewer per step made it faster at the same
// chain length); with few rows, the chain's latency.  K2 reads most of
// every row anyway, so it streams the row and walks it out of shared
// memory, where a read costs tens of cycles instead of hundreds; what is
// left to bound it is bandwidth and the instructions a frame takes.
//
// K1's design: one thread per row, all rows of a tick in one wave.  A step
// issues its loads before it uses any: the two or three aligned 16-byte
// words covering [cur, cur+20), so no sector the head does not span, from
// which the length and the four header words are cut with funnel shifts
// and __byte_perm (one round trip a step; near the row's end, clamped byte
// loads).  A thread keeps eight frames' values in registers and stores
// each plane's eight as two 16-byte streaming stores: whole 32-byte
// sectors, where a 4- or 16-byte store per lane leaves partial sectors for
// device memory to merge, and where staging the planes in shared memory to
// write them as runs took longer than the stores it saved.
//
// K2's design: one warp per row, a persistent grid (as many blocks as fit
// on the card, each warp taking rows w, w+W, ...).  Each warp owns a ring
// of S stages of SB bytes in shared memory.  Lane 0 fills the stages with
// Hopper's bulk asynchronous copy (cp.async.bulk, one mbarrier per stage,
// its phase bit tracked across refills and rows) up to S stages ahead of
// the cursor; a stage is refilled only after the cursor has left it and
// the warp has passed a __syncwarp.  Only the 16-byte aligned interior of
// the row, up to its valid bytes, is staged, so a copy never leaves the
// row: a frame outside the staged window (the row's unaligned head and
// tail, a frame longer than the ring, bytes past L) is read through the
// clamped global path instead.  The warp works in batches: it walks up to
// 32 frames whose head and body are staged (lane k keeps frame k's cursor,
// length and jute length), then emits the batch with every lane busy: each
// lane one frame's seven header values (into a per-warp shared buffer,
// written once per row, or per 64 frames, as seven runs of consecutive
// frames), then the body words four to a lane (16-byte stores where
// DW % 4 == 0, several frames per pass when DW is small), then the Stat
// words of the whole batch, which are consecutive in [B, F, 17].  Before a
// warp leaves a row it drains every copy in flight, starts the next row's
// first stages, and then writes this row's header runs and empty tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u32 = uint32_t;

constexpr int32_t kMaxPacket = 16 * 1024 * 1024;  // protocol/consts.py MAX_PACKET
constexpr int kStatWords = 17;                    // 68-byte Stat as BE words
constexpr int kHdrPlanes = 7;                     // K2: K1's six + dlen
constexpr int kK1Planes = 6;
constexpr int kK1MaxThreads = 64;                 // K1's largest block
constexpr int kK1Group = 8;                       // K1: frames per store group
constexpr int kK2MaxWarps = 8;                    // K2's largest block
constexpr unsigned kFull = 0xffffffffu;
// A bulk copy that has not landed after this many polls means a fault:
// trap rather than hang the card.
constexpr u32 kMaxPolls = 1u << 24;

__device__ __forceinline__ u32 byte_at(const uint8_t* row, u32 off, u32 L) {
  return row[off < L ? off : L - 1];
}

// Big-endian word at `off`, each byte clamped to [0, L-1], assembled
// unsigned and reinterpreted as int32: the signed length, xid and err and
// the (hi, lo) halves.  The slow path of both kernels.
__device__ __forceinline__ int32_t be_clamped(const uint8_t* row, u32 off,
                                              u32 L) {
  return static_cast<int32_t>(
      (byte_at(row, off, L) << 24) | (byte_at(row, off + 1, L) << 16) |
      (byte_at(row, off + 2, L) << 8) | byte_at(row, off + 3, L));
}

// The big-endian word starting `sh / 8` bytes into the little-endian word
// pair (lo, hi) of consecutive memory words.
__device__ __forceinline__ int32_t be_word(u32 lo, u32 hi, u32 sh) {
  return static_cast<int32_t>(__byte_perm(__funnelshift_r(lo, hi, sh), 0,
                                          0x0123));
}

__device__ __forceinline__ u32 clamp_nb(int32_t dlen) {
  return dlen < 0 ? 0u : (dlen > kMaxPacket + 1 ? u32(kMaxPacket + 1) : u32(dlen));
}

// One step of the frame walk at cursor `cur` of a row holding `n` valid
// bytes: the length of the frame whose prefix sits at `cur` when that
// frame is complete, else -1 (and `bad` is set for a length outside
// [0, MAX_PACKET]).  `bad` is sticky: once set, no frame completes.
// `rd.word(off)` is the big-endian int32 at row offset `off`.
template <class Reader>
__device__ __forceinline__ int32_t next_frame(const Reader& rd, u32 n, u32 cur,
                                              bool& bad) {
  if (bad || cur + 4 > n) return -1;
  const int32_t ln = rd.word(cur);
  if (ln < 0 || ln > kMaxPacket) {
    bad = true;
    return -1;
  }
  if (cur + 4 + u32(ln) > n) return -1;
  return ln;
}

// The clamped global reader.
struct GlobalReader {
  const uint8_t* row;
  u32 L;
  __device__ __forceinline__ int32_t word(u32 off) const {
    return be_clamped(row, off, L);
  }
  // words 4q..4q+3 of a body at `o` (0 at and past word `nw`)
  __device__ __forceinline__ int4 quad(u32 o, int w0, u32 nw) const {
    int4 v;
    v.x = u32(w0) < nw ? word(o) : 0;
    v.y = u32(w0 + 1) < nw ? word(o + 4) : 0;
    v.z = u32(w0 + 2) < nw ? word(o + 8) : 0;
    v.w = u32(w0 + 3) < nw ? word(o + 12) : 0;
    return v;
  }
};

// ---------------------------------------------------------------- K1 --

// K1's reader: the five words of a frame head [cur, cur+20), all loaded at
// the top of the step.  w[0] is the length, w[1..4] xid, zxid hi/lo, err.
struct HeadWords {
  u32 cur;
  int32_t w[5];
  __device__ __forceinline__ int32_t word(u32 off) const {
    return w[(off - cur) >> 2];
  }
};

__device__ __forceinline__ HeadWords load_head(const uint8_t* buf,
                                               uintptr_t buf_end,
                                               const uint8_t* row, u32 L,
                                               u32 cur) {
  HeadWords h;
  h.cur = cur;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row) + cur;
  const uintptr_t a16 = a & ~static_cast<uintptr_t>(15);
  if (cur + 20 <= L && a16 >= reinterpret_cast<uintptr_t>(buf) &&
      a16 + 48 <= buf_end) {
    // the aligned 16-byte words covering [cur, cur+20): two, or three
    // where cur % 16 > 12, so a step fetches only the sectors it uses;
    // every byte used lies below L
    const uint4* p = reinterpret_cast<const uint4*>(a16);
    const uint4 x = __ldg(p), y = __ldg(p + 1);
    uint4 z = make_uint4(0, 0, 0, 0);
    if ((a & 15) > 12) z = __ldg(p + 2);
    const u32 v[12] = {x.x, x.y, x.z, x.w, y.x, y.y,
                       y.z, y.w, z.x, z.y, z.z, z.w};
    const u32 q = static_cast<u32>(a >> 2) & 3;
    const u32 sh = static_cast<u32>(a & 3) * 8;
    // t[i] = v[q + i] for i < 6, by two selects (no local memory)
    u32 u[10], t[6];
#pragma unroll
    for (int i = 0; i < 10; ++i) u[i] = (q & 2) ? v[i + 2] : v[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) t[i] = (q & 1) ? u[i + 1] : u[i];
#pragma unroll
    for (int k = 0; k < 5; ++k) h.w[k] = be_word(t[k], t[k + 1], sh);
  } else {
#pragma unroll
    for (int k = 0; k < 5; ++k) h.w[k] = be_clamped(row, cur + 4 * k, L);
  }
  return h;
}

// K1.  hdr is [6, B, F] int32: planes starts, sizes, xid, zxid_hi,
// zxid_lo, err.  One thread per row.  A thread walks kK1Group frames,
// keeping their six values in registers, then stores each plane's group
// as 16-byte stores (4-byte stores where F % 4 != 0); slots past the
// walk's end hold the empty values.
__global__ void __launch_bounds__(kK1MaxThreads)
    wire_scan_kernel(const uint8_t* __restrict__ buf,
                     const int32_t* __restrict__ lens, int B, u32 L, int F,
                     int32_t* __restrict__ hdr, int32_t* __restrict__ counts,
                     int32_t* __restrict__ resid,
                     uint8_t* __restrict__ bad_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const uint8_t* const row = buf + static_cast<int64_t>(r) * L;
  const uintptr_t buf_end =
      reinterpret_cast<uintptr_t>(buf) + static_cast<uint64_t>(B) * L;
  const int32_t n_raw = lens[r];
  bool bad = n_raw < 0;
  const u32 n = bad ? 0u : u32(n_raw);
  const int64_t plane = static_cast<int64_t>(B) * F;
  int32_t* const out = hdr + static_cast<int64_t>(r) * F;
  const bool vec = (F & 3) == 0;
  u32 cur = 0;
  bool walking = true;
  int j = 0;
  for (int j0 = 0; j0 < F; j0 += kK1Group) {
    int32_t s[kK1Planes][kK1Group];
#pragma unroll
    for (int u = 0; u < kK1Group; ++u) {
      int32_t v[kK1Planes] = {-1, 0, 0, 0, 0, 0};
      if (walking && j0 + u < F) {
        const HeadWords h = !bad && cur + 4 <= n
                                ? load_head(buf, buf_end, row, L, cur)
                                : HeadWords{cur, {0, 0, 0, 0, 0}};
        const int32_t ln = next_frame(h, n, cur, bad);
        if (ln < 0) {
          walking = false;
        } else {
          const bool hdr_ok = ln >= 16;
          v[0] = static_cast<int32_t>(cur + 4);
          v[1] = ln;
#pragma unroll
          for (int k = 1; k < 5; ++k) v[k + 1] = hdr_ok ? h.w[k] : 0;
          cur += 4 + u32(ln);
          ++j;
        }
      }
#pragma unroll
      for (int p = 0; p < kK1Planes; ++p) s[p][u] = v[p];
    }
#pragma unroll
    for (int p = 0; p < kK1Planes; ++p) {
      int32_t* const o = out + p * plane + j0;
#pragma unroll
      for (int u = 0; u < kK1Group; u += 4) {
        if (vec) {
          if (j0 + u < F)
            __stcs(reinterpret_cast<int4*>(o + u),
                   make_int4(s[p][u], s[p][u + 1], s[p][u + 2], s[p][u + 3]));
        } else {
#pragma unroll
          for (int k = u; k < u + 4; ++k)
            if (j0 + k < F) o[k] = s[p][k];
        }
      }
    }
  }
  counts[r] = j;
  resid[r] = static_cast<int32_t>(cur);
  bad_out[r] = bad ? 1 : 0;
}

// ---------------------------------------------------------------- K2 --

__device__ __forceinline__ void bar_init(u32 bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_wait(u32 bar, u32 parity) {
  u32 done = 0;
  for (u32 polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16, from a 16-byte aligned address) into
// shared memory at `dst`, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(u32 dst, const void* src, u32 bytes,
                                          u32 bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One warp's ring: stage k holds row bytes [hoff + k*SB, hoff + (k+1)*SB)
// (clipped to lim) in slot k % S.  Stages [base, ready) have landed and
// been waited for; [ready, top) are in flight.  Every lane keeps the same
// copy of this state: every call below is made by the whole warp.
struct Ring {
  const u32* words;  // the ring, S*SB bytes
  u32 smem;          // its shared address
  u32 bars;          // shared address of its S mbarriers
  u32 wmask;         // S*SB/4 - 1
  int sb_shift;      // SB = 1 << sb_shift
  int S;
  int lane;
  const uint8_t* src;  // row + hoff, 16-byte aligned
  u32 hoff;            // row offset of stage 0 (0..15)
  u32 lim;             // row offset past the last staged byte (<= L)
  int NS;              // the row's stages
  int base, ready, top;
  u32 phase;           // bit s: parity of slot s's next completion

  __device__ __forceinline__ u32 stage_start(int k) const {
    return hoff + (u32(k) << sb_shift);
  }

  __device__ __forceinline__ void wait_next() {
    const int s = ready & (S - 1);
    bar_wait(bars + 8 * s, (phase >> s) & 1);
    phase ^= 1u << s;
    ++ready;
  }

  // issue stages up to S ahead of base
  __device__ __forceinline__ void refill() {
    const int end = min(NS, base + S);
    if (top >= end) return;
    __syncwarp();  // every lane is done reading the slots being reused
    if (lane == 0) {
      for (int k = top; k < end; ++k) {
        const int s = k & (S - 1);
        const u32 off = u32(k) << sb_shift;
        const u32 left = lim - hoff - off;
        const u32 sb = 1u << sb_shift;
        bulk_load(smem + (u32(s) << sb_shift), src + off,
                  left < sb ? left : sb, bars + 8 * s);
      }
    }
    top = end;
  }

  // start a row: its staged window and first stages
  __device__ __forceinline__ void open(const uint8_t* row, u32 L, u32 n,
                                       bool stage) {
    const uintptr_t ra = reinterpret_cast<uintptr_t>(row);
    hoff = static_cast<u32>((16 - (ra & 15)) & 15);
    src = row + hoff;
    // row offset of the last 16-byte boundary at or before L
    const int64_t end = static_cast<int64_t>(
        ((ra + L) & ~static_cast<uintptr_t>(15)) - (ra & ~static_cast<uintptr_t>(15))) -
        static_cast<int64_t>(ra & 15);
    const int64_t want =
        n <= hoff ? hoff : int64_t{hoff} + ((int64_t{n} - hoff + 15) & ~int64_t{15});
    const int64_t e = end < want ? end : want;
    lim = (!stage || e < int64_t{hoff}) ? hoff : u32(e);
    NS = static_cast<int>((lim - hoff + (1u << sb_shift) - 1) >> sb_shift);
    base = ready = top = 0;
    refill();
  }

  // the cursor moved to `cur`: release the stages before it
  __device__ __forceinline__ void advance(u32 cur) {
    if (cur < hoff) return;
    const u32 k = (cur - hoff) >> sb_shift;
    const int want = k < u32(NS) ? int(k) : NS;
    if (want <= base) return;
    // stages released before being read still have a copy landing in
    // their slot: wait for it before the slot is reused
    const int drain = want < top ? want : top;
    while (ready < drain) wait_next();
    base = want;
    if (ready < base) ready = base;
    if (top < base) top = base;
    refill();
  }

  // wait for every issued stage that starts before row offset `e`
  __device__ __forceinline__ void ensure(u32 e) {
    while (ready < top && stage_start(ready) < e) wait_next();
  }

  // are row bytes [s, e) all in landed stages?
  __device__ __forceinline__ bool staged(u32 s, u32 e) const {
    const u32 hi = stage_start(ready);
    return s >= stage_start(base) && e <= (hi < lim ? hi : lim);
  }

  __device__ __forceinline__ void drain() {
    while (ready < top) wait_next();
  }
};

// K2's shared-memory reader: row bytes that Ring::staged() vouched for.
struct RingReader {
  const u32* words;
  u32 wmask;
  u32 hoff;
  __device__ __forceinline__ int32_t word(u32 off) const {
    const u32 rel = off - hoff;
    const u32 i = rel >> 2;
    return be_word(words[i & wmask], words[(i + 1) & wmask], (rel & 3) * 8);
  }
  __device__ __forceinline__ int4 quad(u32 o, int w0, u32 nw) const {
    const u32 rel = o - hoff;
    const u32 i = rel >> 2, sh = (rel & 3) * 8;
    const u32 a = words[i & wmask], b = words[(i + 1) & wmask],
              c = words[(i + 2) & wmask], d = words[(i + 3) & wmask],
              e = words[(i + 4) & wmask];
    int4 v;
    v.x = u32(w0) < nw ? be_word(a, b, sh) : 0;
    v.y = u32(w0 + 1) < nw ? be_word(b, c, sh) : 0;
    v.z = u32(w0 + 2) < nw ? be_word(c, d, sh) : 0;
    v.w = u32(w0 + 3) < nw ? be_word(d, e, sh) : 0;
    return v;
  }
};

// The data words a hdr_ok frame with jute length `dlen` emits.
__device__ __forceinline__ u32 data_words(int32_t dlen, int DW) {
  const u32 w = (clamp_nb(dlen) + 3) >> 2;
  return w < u32(DW) ? w : u32(DW);
}

// How K2's lanes split a frame's body: G items a frame (16-byte quads
// where DW % 4 == 0, else single words), lane -> (frame lf of a pass of
// fpi frames, item lq), items lq, lq + qstep, ...
struct BodySplit {
  bool vec;
  int G, lf, lq, fpi, qstep;
};

// Emit a walked batch of m frames (slots slot0 .. slot0+m-1); lane k holds
// frame k's cursor, length and jute length (0 unless hdr_ok).  The header
// values go to hb[p * HF + k], the body words and Stat words to device
// memory.
template <class Reader>
__device__ __forceinline__ void emit_batch(
    const Reader& rd, int lane, int m, int64_t slot0, u32 f_cur, int32_t f_ln,
    int32_t f_dlen, int DW, const BodySplit& bs, int32_t* hb, int HF,
    int32_t* __restrict__ dw, int32_t* __restrict__ sw) {
  if (lane < m) {
    const bool hdr_ok = f_ln >= 16;
    int32_t* const h = hb + lane;
    h[0] = static_cast<int32_t>(f_cur + 4);
    h[HF] = f_ln;
    h[2 * HF] = hdr_ok ? rd.word(f_cur + 4) : 0;
    h[3 * HF] = hdr_ok ? rd.word(f_cur + 8) : 0;
    h[4 * HF] = hdr_ok ? rd.word(f_cur + 12) : 0;
    h[5 * HF] = hdr_ok ? rd.word(f_cur + 16) : 0;
    h[6 * HF] = f_dlen;
  }
  if (bs.G > 0) {
    for (int f0 = 0; f0 < m; f0 += bs.fpi) {
      const int f = f0 + bs.lf;
      const int from = f < 31 ? f : 31;
      const u32 fc = __shfl_sync(kFull, f_cur, from);
      const int32_t fl = __shfl_sync(kFull, f_ln, from);
      const int32_t fd = __shfl_sync(kFull, f_dlen, from);
      if (bs.lf < bs.fpi && f < m) {
        const u32 nw = fl >= 16 ? data_words(fd, DW) : 0u;
        int32_t* const ds = dw + (slot0 + f) * DW;
        for (int q = bs.lq; q < bs.G; q += bs.qstep) {
          if (bs.vec) {
            reinterpret_cast<int4*>(ds)[q] = rd.quad(fc + 24 + 16 * q, 4 * q, nw);
          } else {
            ds[q] = u32(q) < nw ? rd.word(fc + 24 + 4 * q) : 0;
          }
        }
      }
    }
  }
  // the batch's Stat words are consecutive in [B, F, 17]
  int32_t* const ss = sw + slot0 * kStatWords;
  for (int t0 = 0; t0 < m * kStatWords; t0 += 32) {
    const int t = t0 + lane;
    const int f = t / kStatWords;
    const int from = f < 31 ? f : 31;
    const u32 fc = __shfl_sync(kFull, f_cur, from);
    const int32_t fl = __shfl_sync(kFull, f_ln, from);
    const int32_t fd = __shfl_sync(kFull, f_dlen, from);
    if (t < m * kStatWords) {
      const u32 nb = clamp_nb(fd);
      const bool s_ok = fl >= 16 && 20 + nb + 68 <= u32(fl);
      ss[t] = s_ok ? rd.word(fc + 24 + nb + 4 * (t - f * kStatWords)) : 0;
    }
  }
}

// Write the buffered header values of frames [c0, c0 + cnt) of a row.
__device__ __forceinline__ void flush_headers(const int32_t* hbuf, int HF,
                                              int cnt, int lane,
                                              int32_t* __restrict__ hdr,
                                              int64_t plane, int64_t at) {
  __syncwarp();
  for (int p = 0; p < kHdrPlanes; ++p)
    for (int i = lane; i < cnt; i += 32) hdr[p * plane + at + i] = hbuf[p * HF + i];
  __syncwarp();
}

// K2.  hdr is [7, B, F] int32: planes starts, sizes, xid, zxid_hi,
// zxid_lo, err, dlen in that order.  dw is [B, F, DW], sw is [B, F, 17].
// Shared memory per block: wpb*S mbarriers (rounded to 16 bytes), wpb
// rings of S << sb_shift bytes, wpb header buffers of 7 x HF ints.
__global__ void __launch_bounds__(32 * kK2MaxWarps, 4)
    full_scan_kernel(const uint8_t* __restrict__ buf,
                     const int32_t* __restrict__ lens, int B, u32 L, int F,
                     int DW, int sb_shift, int S, int HF,
                     int32_t* __restrict__ hdr, int32_t* __restrict__ dw,
                     int32_t* __restrict__ sw, int32_t* __restrict__ counts,
                     int32_t* __restrict__ resid,
                     uint8_t* __restrict__ bad_out) {
  extern __shared__ __align__(16) uint8_t k2s[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int bar_bytes = (wpb * S * 8 + 15) & ~15;
  uint8_t* const ring_p =
      k2s + bar_bytes + (static_cast<size_t>(warp * S) << sb_shift);
  int32_t* const hbuf =
      reinterpret_cast<int32_t*>(
          k2s + bar_bytes + (static_cast<size_t>(wpb * S) << sb_shift)) +
      warp * kHdrPlanes * HF;

  Ring g;
  g.words = reinterpret_cast<const u32*>(ring_p);
  g.smem = static_cast<u32>(__cvta_generic_to_shared(ring_p));
  g.bars = static_cast<u32>(__cvta_generic_to_shared(k2s)) + warp * S * 8;
  g.wmask = (u32(S) << (sb_shift - 2)) - 1;
  g.sb_shift = sb_shift;
  g.S = S;
  g.lane = lane;
  g.phase = 0;
  if (lane == 0) {
    for (int s = 0; s < S; ++s) bar_init(g.bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  BodySplit bs;
  bs.vec = (DW & 3) == 0;
  bs.G = bs.vec ? DW >> 2 : DW;
  const int G = bs.G > 0 ? bs.G : 1;
  bs.lf = G <= 32 ? lane / G : 0;
  bs.lq = G <= 32 ? lane - bs.lf * G : lane;
  bs.fpi = G <= 32 ? 32 / G : 1;
  bs.qstep = G <= 32 ? G : 32;

  const int64_t plane = static_cast<int64_t>(B) * F;
  const int W = gridDim.x * wpb;
  int r = blockIdx.x * wpb + warp;
  int32_t n_raw = r < B ? lens[r] : 0;
  if (r < B)
    g.open(buf + static_cast<int64_t>(r) * L, L, n_raw < 0 ? 0u : u32(n_raw),
           F > 0);
  while (r < B) {
    const uint8_t* const row = buf + static_cast<int64_t>(r) * L;
    const int nr = r + W;
    const int32_t n_next = nr < B ? lens[nr] : 0;  // loaded early
    const int64_t base_o = static_cast<int64_t>(r) * F;
    const GlobalReader gr{row, L};
    const RingReader rr{g.words, g.wmask, g.hoff};
    bool bad = n_raw < 0;
    const u32 n = bad ? 0u : u32(n_raw);
    u32 cur = 0;
    int j = 0, c0 = 0;
    bool done = F == 0;
    while (!done) {
      g.advance(cur);
      // walk a batch: frames whose head and body are staged, or else one
      // frame read from device memory
      int m = 0;
      bool slow = false;
      u32 f_cur = 0;
      int32_t f_ln = 0, f_dlen = 0;
      while (m < 32 && j + m < F) {
        if (bad || cur + 4 > n) {
          done = true;
          break;
        }
        g.ensure(cur + 24);
        const bool head_fast = g.staged(cur, cur + 24);
        if (!head_fast && m > 0) break;
        const int32_t ln = head_fast ? next_frame(rr, n, cur, bad)
                                     : next_frame(gr, n, cur, bad);
        if (ln < 0) {
          done = true;
          break;
        }
        const bool hdr_ok = ln >= 16;
        const int32_t dlen =
            hdr_ok ? (head_fast ? rr.word(cur + 20) : gr.word(cur + 20)) : 0;
        bool body_fast = head_fast;
        if (head_fast && hdr_ok) {
          const u32 nb = clamp_nb(dlen);
          u32 bend = cur + 24 + 4 * data_words(dlen, DW);
          if (20 + nb + 68 <= u32(ln) && cur + 24 + nb + 68 > bend)
            bend = cur + 24 + nb + 68;
          if (bend > cur + 24) {
            g.ensure(bend);
            body_fast = g.staged(cur + 24, bend);
          }
          if (!body_fast && m > 0) break;
        }
        if (lane == m) {
          f_cur = cur;
          f_ln = ln;
          f_dlen = dlen;
        }
        ++m;
        cur += 4 + u32(ln);
        if (!body_fast) {
          slow = true;
          break;
        }
      }
      if (m > 0) {
        if (j + m - c0 > HF) {
          flush_headers(hbuf, HF, j - c0, lane, hdr, plane, base_o + c0);
          c0 = j;
        }
        if (slow)
          emit_batch(gr, lane, m, base_o + j, f_cur, f_ln, f_dlen, DW, bs,
                     hbuf + (j - c0), HF, dw, sw);
        else
          emit_batch(rr, lane, m, base_o + j, f_cur, f_ln, f_dlen, DW, bs,
                     hbuf + (j - c0), HF, dw, sw);
        j += m;
      }
      if (j >= F) done = true;
    }
    // leave the row: drain its copies, start the next row's, then write
    // this row's header runs, empty tail and scalars
    g.drain();
    if (nr < B)
      g.open(buf + static_cast<int64_t>(nr) * L, L, n_next < 0 ? 0u : u32(n_next),
             F > 0);
    flush_headers(hbuf, HF, j - c0, lane, hdr, plane, base_o + c0);
    for (int p = 0; p < kHdrPlanes; ++p) {
      int32_t* const out = hdr + p * plane + base_o;
      const int32_t empty = p == 0 ? -1 : 0;
      for (int i = j + lane; i < F; i += 32) out[i] = empty;
    }
    const int tail = F - j;
    int32_t* const dt = dw + (base_o + j) * DW;
    if (bs.vec) {
      const int4 z = make_int4(0, 0, 0, 0);
      const int64_t n4 = static_cast<int64_t>(tail) * (DW >> 2);
      for (int64_t k = lane; k < n4; k += 32) reinterpret_cast<int4*>(dt)[k] = z;
    } else {
      const int64_t nd = static_cast<int64_t>(tail) * DW;
      for (int64_t k = lane; k < nd; k += 32) dt[k] = 0;
    }
    int32_t* const st = sw + (base_o + j) * kStatWords;
    for (int k = lane; k < tail * kStatWords; k += 32) st[k] = 0;
    if (lane == 0) {
      counts[r] = j;
      resid[r] = static_cast<int32_t>(cur);
      bad_out[r] = bad ? 1 : 0;
    }
    r = nr;
    n_raw = n_next;
  }
}

}  // namespace

// Plain C launchers, bound with ctypes.  Each launches on `stream` and
// returns a CUDA error code (0 = launched).  The geometry comes from the
// Python wrappers' launch_config().
extern "C" int wire_scan_launch(const void* buf, const void* lens, int B,
                                long long L, int F, int threads, int blocks,
                                void* hdr, void* counts, void* resid,
                                void* bad, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (L < 1 || L > INT32_MAX || threads <= 0 || threads > kK1MaxThreads ||
      blocks <= 0 || static_cast<long long>(blocks) * threads < B)
    return static_cast<int>(cudaErrorInvalidValue);
  wire_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(lens), B,
      static_cast<u32>(L), F, static_cast<int32_t*>(hdr),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(resid),
      static_cast<uint8_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of full_scan_kernel, `warps` warps and `smem` bytes of dynamic
// shared memory each, that the current device holds at once (into
// *blocks).  It first lets the kernel take up to the device's opt-in
// shared memory per block (above 48 KB a launch needs that), so one call
// serves every geometry; the occupancy is computed for `smem` itself.
// The wrapper asks once per device and geometry and sizes the persistent
// grid from the answer; a launch asks nothing.
extern "C" int full_scan_resident(int warps, int smem, int* blocks) {
  if (warps <= 0 || warps > kK2MaxWarps || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(full_scan_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, full_scan_kernel, 32 * warps, smem)) != cudaSuccess)
    return static_cast<int>(e);
  *blocks = per_sm * sms;
  return 0;
}

// `blocks` is the grid: the wrapper caps it at full_scan_resident's answer,
// and the blocks' warps loop over the rows.
extern "C" int full_scan_launch(const void* buf, const void* lens, int B,
                                long long L, int F, int DW, int warps,
                                int sb_shift, int stages, int hdr_frames,
                                int smem, int blocks, void* hdr, void* dw,
                                void* sw, void* counts, void* resid,
                                void* bad, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (L < 1 || L > INT32_MAX || warps <= 0 || warps > kK2MaxWarps ||
      stages < 2 || (stages & (stages - 1)) || sb_shift < 4 ||
      (hdr_frames < 32 && hdr_frames < F) || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  full_scan_kernel<<<blocks, 32 * warps, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(lens), B,
      static_cast<u32>(L), F, DW, sb_shift, stages, hdr_frames,
      static_cast<int32_t*>(hdr), static_cast<int32_t*>(dw),
      static_cast<int32_t*>(sw), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(resid), static_cast<uint8_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}
