// zkwire: native host-side frame scanner for zkstream_tpu_torch (the
// port's own copy of the JAX package's native/zkwire.cpp).
//
// The device path (kernels K1/K2, csrc/wire_scan.cu) handles
// fleet-scale batched decode; this library is its host-side
// counterpart for the per-connection scalar path run on every socket
// read — the same role the reference's per-connection decode loop
// plays (lib/zk-streams.js:39-99 and the drain in
// lib/connection-fsm.js:213-229), hoisted out of interpreted Python
// into C++.
//
// Exposed as a plain C ABI consumed via ctypes
// (zkstream_tpu_torch/utils/native.py); no Python.h dependency, so it
// builds with a bare g++ -shared into build/ and the Python layer
// degrades gracefully when the library is absent.

#include <cstdint>
#include <cstring>

namespace {

inline int32_t be32(const uint8_t *p) {
  return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                   ((uint32_t)p[2] << 8) | (uint32_t)p[3]);
}

}  // namespace

extern "C" {

// Slice complete length-prefixed frames out of buf[0:len].
//
// Writes up to max_frames (body_start, body_size) pairs.  Returns the
// number of complete frames found, or -1 on an invalid length prefix
// (negative or > max_packet — the BAD_LENGTH condition of
// lib/zk-streams.js:47-53).  *resid receives the cursor after the last
// complete frame (bytes from there to len are a partial frame for the
// caller to keep buffered); on BAD_LENGTH it receives the offending
// frame's prefix offset.
int32_t zkwire_frame_scan(const uint8_t *buf, int32_t len,
                          int32_t max_packet, int32_t max_frames,
                          int32_t *starts, int32_t *sizes,
                          int32_t *resid) {
  int32_t off = 0, n = 0;
  while (n < max_frames && len - off >= 4) {
    int32_t ln = be32(buf + off);
    if (ln < 0 || ln > max_packet) {
      *resid = off;
      return -1;
    }
    if (len - off < 4 + ln) break;
    starts[n] = off + 4;
    sizes[n] = ln;
    ++n;
    off += 4 + ln;
  }
  *resid = off;
  return n;
}

// ABI version tag so the Python loader can reject a stale build.
int32_t zkwire_abi_version(void) { return 1; }

}  // extern "C"
