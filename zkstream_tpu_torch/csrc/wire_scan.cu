// K1 and K2: the frame walk of a fleet of reply streams, on an H100.
//
// K1 (wire_scan_kernel) replaces zkstream_tpu/ops/pallas_scan.py::_kernel
// (launched by pallas_wire_scan).  K2 (full_scan_kernel) replaces
// pallas_scan.py::_full_kernel (launched by pallas_wire_full_scan): K1's
// walk plus the GET_DATA body in the same pass.  Both call one frame step,
// next_frame(), so their frame state machines cannot diverge (the Pallas
// kernels share _scan_frame for the same reason).
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
// Bound on an H100: memory.  K1 reads 20 bytes per frame found plus 4 of
// `lens` per row and writes 24 per frame slot plus 9 per row.  K2 also
// reads the body words it emits and writes 4*(1+DW+17) more bytes per
// frame slot: 352 B a slot at max_data=256 against K1's 24.
//
// Designs.  K1: one thread per row, a sequential loop over the frame
// slots, byte loads from global memory.  K2: one warp per row.  The walk
// state is the same in every lane (each lane runs next_frame on the same
// bytes, so the loads broadcast), and the lanes split a frame's DW+17
// body words between them, so consecutive lanes load consecutive bytes
// and store consecutive words: each store of the [B, F, DW] and
// [B, F, 17] planes is coalesced.  Lanes 0..6 store the seven [B, F]
// header planes.  In both kernels, once a step completes no frame, no
// later step can (the cursor stops and the same prefix is re-read), so the
// walk writes the empty tail and stops.  Every byte offset is clamped to
// [0, L-1] as the plain version's _byte_at clamps it, so lens > L reads
// agree.  Extent arithmetic runs in 64 bits, so a length near INT32_MAX
// cannot wrap the cursor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxPacket = 16 * 1024 * 1024;  // protocol/consts.py MAX_PACKET
constexpr int kStatWords = 17;                    // 68-byte Stat as BE words
constexpr int kHdrPlanes = 7;                     // K2: K1's six + dlen

__device__ __forceinline__ uint32_t byte_at(const uint8_t* row, int64_t off,
                                            int64_t L) {
  off = off < 0 ? 0 : (off > L - 1 ? L - 1 : off);
  return static_cast<uint32_t>(row[off]);
}

// Big-endian word at `off`, assembled unsigned and reinterpreted as int32:
// that reproduces the signed length, xid and err and the (hi, lo) halves.
__device__ __forceinline__ int32_t be_i32(const uint8_t* row, int64_t off,
                                          int64_t L) {
  uint32_t w = (byte_at(row, off, L) << 24) | (byte_at(row, off + 1, L) << 16) |
               (byte_at(row, off + 2, L) << 8) | byte_at(row, off + 3, L);
  return static_cast<int32_t>(w);
}

// One step of the frame walk at cursor `cur` of a row holding `n` valid
// bytes: the length of the frame whose prefix sits at `cur` when that
// frame is complete, else -1 (and `bad` is set for a length outside
// [0, MAX_PACKET]).  `bad` is sticky: once set, no frame completes.
__device__ __forceinline__ int32_t next_frame(const uint8_t* row, int64_t L,
                                              int64_t n, int64_t cur,
                                              bool& bad) {
  if (bad || cur + 4 > n) return -1;
  const int32_t ln = be_i32(row, cur, L);
  if (ln < 0 || ln > kMaxPacket) {
    bad = true;
    return -1;
  }
  if (cur + 4 + ln > n) return -1;
  return ln;
}

__global__ void wire_scan_kernel(const uint8_t* __restrict__ buf,
                                 const int32_t* __restrict__ lens, int B,
                                 int64_t L, int F, int32_t* __restrict__ starts,
                                 int32_t* __restrict__ sizes,
                                 int32_t* __restrict__ xid,
                                 int32_t* __restrict__ zhi,
                                 int32_t* __restrict__ zlo,
                                 int32_t* __restrict__ err,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ resid,
                                 uint8_t* __restrict__ bad_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const uint8_t* row = buf + static_cast<int64_t>(r) * L;
  const int64_t n = lens[r];
  const int64_t base = static_cast<int64_t>(r) * F;
  int64_t cur = 0;
  bool bad = n < 0;
  int j = 0;
  for (; j < F; ++j) {
    const int32_t ln = next_frame(row, L, n, cur, bad);
    if (ln < 0) break;
    const int64_t o = base + j;
    starts[o] = static_cast<int32_t>(cur + 4);
    sizes[o] = ln;
    if (ln >= 16) {
      xid[o] = be_i32(row, cur + 4, L);
      zhi[o] = be_i32(row, cur + 8, L);
      zlo[o] = be_i32(row, cur + 12, L);
      err[o] = be_i32(row, cur + 16, L);
    } else {
      xid[o] = 0;
      zhi[o] = 0;
      zlo[o] = 0;
      err[o] = 0;
    }
    cur += 4 + ln;
  }
  counts[r] = j;
  for (int k = j; k < F; ++k) {
    const int64_t o = base + k;
    starts[o] = -1;
    sizes[o] = 0;
    xid[o] = 0;
    zhi[o] = 0;
    zlo[o] = 0;
    err[o] = 0;
  }
  resid[r] = static_cast<int32_t>(cur);
  bad_out[r] = bad ? 1 : 0;
}

// K2.  hdr is [7, B, F] int32: planes starts, sizes, xid, zxid_hi,
// zxid_lo, err, dlen in that order.  dw is [B, F, DW], sw is [B, F, 17].
// One warp per row; blockDim.x is a multiple of 32.
__global__ void full_scan_kernel(const uint8_t* __restrict__ buf,
                                 const int32_t* __restrict__ lens, int B,
                                 int64_t L, int F, int DW,
                                 int32_t* __restrict__ hdr,
                                 int32_t* __restrict__ dw,
                                 int32_t* __restrict__ sw,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ resid,
                                 uint8_t* __restrict__ bad_out) {
  const int lane = threadIdx.x & 31;
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= B) return;  // whole warps leave together
  const uint8_t* row = buf + static_cast<int64_t>(r) * L;
  const int64_t n = lens[r];
  const int64_t plane = static_cast<int64_t>(B) * F;
  const int64_t base = static_cast<int64_t>(r) * F;
  int32_t* const my_plane = hdr + (lane < kHdrPlanes ? lane : 0) * plane;
  int64_t cur = 0;
  bool bad = n < 0;
  int j = 0;
  for (; j < F; ++j) {
    const int32_t ln = next_frame(row, L, n, cur, bad);
    if (ln < 0) break;
    const bool hdr_ok = ln >= 16;
    const int32_t dlen = hdr_ok ? be_i32(row, cur + 20, L) : 0;
    const int64_t nb = dlen < 0 ? 0 : (dlen > kMaxPacket + 1 ? kMaxPacket + 1
                                                               : dlen);
    if (lane < kHdrPlanes) {
      // lane k stores plane k; planes 2..6 sit at cur + 4k - 4
      int32_t v;
      if (lane == 0) {
        v = static_cast<int32_t>(cur + 4);
      } else if (lane == 1) {
        v = ln;
      } else if (lane == 6) {
        v = dlen;
      } else {
        v = hdr_ok ? be_i32(row, cur + 4 * lane - 4, L) : 0;
      }
      my_plane[base + j] = v;
    }
    const int64_t slot = base + j;
    int32_t* const dslot = dw + slot * DW;
    for (int w = lane; w < DW; w += 32) {
      dslot[w] = (hdr_ok && 4 * static_cast<int64_t>(w) < nb)
                     ? be_i32(row, cur + 24 + 4 * w, L)
                     : 0;
    }
    const bool s_ok = hdr_ok && 20 + nb + 68 <= ln;
    if (lane < kStatWords) {
      sw[slot * kStatWords + lane] =
          s_ok ? be_i32(row, cur + 24 + nb + 4 * lane, L) : 0;
    }
    cur += 4 + ln;
  }
  // the empty tail j..F-1: starts -1, everything else 0
  const int tail = F - j;
  for (int k = lane; k < kHdrPlanes * tail; k += 32) {
    const int p = k / tail;
    hdr[p * plane + base + j + (k - p * tail)] = p == 0 ? -1 : 0;
  }
  const int64_t dtail = static_cast<int64_t>(tail) * DW;
  int32_t* const dt = dw + (base + j) * DW;
  for (int64_t k = lane; k < dtail; k += 32) dt[k] = 0;
  int32_t* const st = sw + (base + j) * kStatWords;
  for (int k = lane; k < tail * kStatWords; k += 32) st[k] = 0;
  if (lane == 0) {
    counts[r] = j;
    resid[r] = static_cast<int32_t>(cur);
    bad_out[r] = bad ? 1 : 0;
  }
}

}  // namespace

// Plain C launchers, bound with ctypes.  Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int wire_scan_launch(const void* buf, const void* lens, int B,
                                long long L, int F, void* starts, void* sizes,
                                void* xid, void* zhi, void* zlo, void* err,
                                void* counts, void* resid, void* bad,
                                void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  wire_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(lens), B,
      static_cast<int64_t>(L), F, static_cast<int32_t*>(starts),
      static_cast<int32_t*>(sizes), static_cast<int32_t*>(xid),
      static_cast<int32_t*>(zhi), static_cast<int32_t*>(zlo),
      static_cast<int32_t*>(err), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(resid), static_cast<uint8_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int full_scan_launch(const void* buf, const void* lens, int B,
                                long long L, int F, int DW, void* hdr,
                                void* dw, void* sw, void* counts, void* resid,
                                void* bad, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int rows_per_block = 4;  // 4 warps, 128 threads
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  full_scan_kernel<<<blocks, 32 * rows_per_block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(lens), B,
      static_cast<int64_t>(L), F, DW, static_cast<int32_t*>(hdr),
      static_cast<int32_t*>(dw), static_cast<int32_t*>(sw),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(resid),
      static_cast<uint8_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}
