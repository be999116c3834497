// K1: fused frame scan + reply-header parse for a fleet of streams.
//
// Replaces zkstream_tpu/ops/pallas_scan.py::_kernel (launched by
// pallas_wire_scan).  Computes exactly what the plain version
// zkstream_tpu_torch/ops/frame_scan.py::frame_cursor_scan +
// ops/headers.py::parse_reply_headers compute:
//
//   per stream row, a max_frames-step cursor walk.  At each step read the
//   big-endian int32 length at cur; a length < 0 or > MAX_PACKET sets a
//   sticky `bad`.  The frame is complete if cur+4+len <= n: emit
//   start = cur+4 (else -1) and size = len (else 0).  If also len >= 16,
//   read xid (+4), zxid hi (+8), zxid lo (+12) and err (+16) (else 0).
//   After the walk write resid (the final cursor), bad and the count of
//   complete frames.
//
// Bound on an H100: memory.  The walk reads 20 bytes per frame found
// (length prefix + 16-byte reply header) plus 4 bytes of `lens` per row,
// and writes 24 bytes per frame slot plus 9 per row.  The TPU kernel's
// lane rolls and one-hot lane reductions existed because Mosaic has no
// vector gather; here a thread loads bytes directly.
//
// Design (first, simple version): one thread per row, a sequential loop
// over the frame slots, byte loads from global memory.  Once a step does
// not complete a frame, no later step can (the cursor stops and the same
// prefix is re-read), so the loop writes the empty tail and stops early.
// Every byte offset is clamped to [0, L-1] as the plain version's
// _byte_at clamps it, so lens > L reads agree.  The extent test runs in
// 64 bits, so a length near INT32_MAX cannot wrap the cursor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kMaxPacket = 16 * 1024 * 1024;  // protocol/consts.py MAX_PACKET

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
    if (bad || cur + 4 > n) break;
    const int32_t ln = be_i32(row, cur, L);
    if (ln < 0 || ln > kMaxPacket) {
      bad = true;
      break;
    }
    if (cur + 4 + ln > n) break;
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

}  // namespace

// Plain C launcher, bound with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
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
