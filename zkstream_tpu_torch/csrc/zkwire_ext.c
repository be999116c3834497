/* _zkwire_ext_torch: CPython-extension codec and transport calls for
 * the per-connection hot paths of zkstream_tpu_torch (the PyTorch/CUDA
 * port).
 *
 * This is the port's own copy of native/zkwire_ext.c (the JAX package's
 * extension), in two halves:
 *
 * - the codec: setup, the reply and request decoders, the encoders and
 *   abi_version (described below);
 * - the transport: crc32c (the write-ahead log's record checksum,
 *   server/persist.py), submit_writev (the send plane's batched writes,
 *   io/transport.py), drain_recv (the server's batched receive,
 *   io/ingress.py) and the io_uring ring (uring_create / uring_submit /
 *   uring_recv / uring_close; on a non-Linux build each raises ENOSYS).
 *
 * The module has a name and an ABI number of its own, so both
 * extensions can live in one process, each with its own statics (the
 * record classes and name tables setup() registers) set up from its own
 * package.
 *
 * Why the codec exists: the pure-Python scalar decode spends most of its
 * time in jute primitive reads — per-field struct.unpack_from calls,
 * bounds checks, and dict/dataclass plumbing in
 * protocol/{jute,records}.py.  Framing alone is cheap (the plain-C-ABI
 * scanner in zkwire.cpp covers it), so the profitable native boundary is
 * the *whole* receive transform: accumulated bytes -> list of packet
 * dicts, in one C pass.  That is the same span the reference executes
 * per socket read (frame loop lib/zk-streams.js:39-99 + reply parse
 * lib/zk-buffer.js:275-370).  FleetIngest (io/ingest.py) hands it each
 * stream's frame-complete slice after the device scan in
 * body_mode='host'.
 *
 * Contract (mirrors PacketCodec.decode exactly; A/B-tested in
 * tests/test_torch_native_ext.py):
 *
 *   decode_responses(buf, xid_map, max_packet)
 *     -> (pkts, consumed, err_kind, err_msg)
 *
 * - Slices every complete length-prefixed frame out of buf[0:len];
 *   `consumed` is the byte offset the caller must drop from its
 *   accumulation buffer.
 * - Each frame decodes to the same packet dict the Python codec builds:
 *   xid/zxid/err + opcode-specific body fields (data/stat/path/children/
 *   acl/type/state), with Stat/ACL/Id constructed through the Python
 *   classes registered via setup().
 * - Bad length prefix (negative or > max_packet): err_kind BAD_LENGTH,
 *   consumed = offset of the offending prefix, pkts = [] (frames
 *   before it are consumed-and-dropped — identical to
 *   FrameDecoder.feed raising mid-scan).
 * - Undecodable frame body: err_kind BAD_DECODE, pkts = packets decoded
 *   before the bad frame (PacketCodec attaches them to the raised
 *   error), consumed = all complete frames (they left the buffer in the
 *   scalar path too).
 * - xids are popped from xid_map exactly as records.read_response does.
 *
 * Built with a bare `gcc -shared -fPIC` against the interpreter's
 * headers into build/; loaded via zkstream_tpu_torch/utils/native.py
 * with the same version-named-artifact discipline as the C-ABI scanner.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <stdint.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#ifdef __linux__
#include <sys/mman.h>
#include <sys/syscall.h>
#endif

/* the loader (utils/native.py _EXT_ABI_VERSION) rejects any other */
#define ZKWIRE_EXT_TORCH_ABI 2

/* ---- registered Python objects (held forever once set) ---- */

static PyObject *g_stat_cls;    /* records.Stat */
static PyObject *g_acl_cls;    /* records.ACL */
static PyObject *g_id_cls;     /* records.Id */
static PyObject *g_perm_cls;   /* consts.Perm (IntFlag) */
static PyObject *g_create_flag_cls; /* consts.CreateFlag (IntFlag) */
static PyObject *g_err_names;  /* dict int -> str (ErrCode names) */
static PyObject *g_notif_types; /* dict int -> str */
static PyObject *g_states;     /* dict int -> str (KeeperState names) */
static PyObject *g_layouts;    /* dict opcode-str -> layout int */
static PyObject *g_req_opcodes; /* dict int -> (name, req-layout int) */
static PyObject *g_op_names;   /* dict int -> str: EVERY valid OpCode */

/* interned key + special-opcode strings */
static PyObject *s_xid, *s_zxid, *s_err, *s_opcode, *s_data, *s_stat,
    *s_path, *s_children, *s_acl, *s_type, *s_state, *s_watch,
    *s_version, *s_relZxid, *s_events, *s_flags, *s_mode;
static PyObject *s_notification, *s_ping, *s_auth, *s_set_watches, *s_ok;
static PyObject *s_dataChanged, *s_createdOrDestroyed,
    *s_childrenChanged, *s_persistent, *s_persistentRecursive;
/* MULTI (opcode 14) framing: result/ops keys + sub-op names */
static PyObject *s_results, *s_op, *s_ops, *s_op_create, *s_op_delete,
    *s_op_set_data, *s_op_check, *s_op_error;
/* attribute names for ACL entries (records.ACL / records.Id) */
static PyObject *s_perms, *s_scheme, *s_id_attr;

/* layout enum — the Python side builds g_layouts with these values */
enum {
  LAYOUT_EMPTY = 0,
  LAYOUT_GET_CHILDREN = 1,
  LAYOUT_GET_CHILDREN2 = 2,
  LAYOUT_CREATE = 3,
  LAYOUT_GET_ACL = 4,
  LAYOUT_GET_DATA = 5,
  LAYOUT_STAT_ONLY = 6,
  LAYOUT_NOTIFICATION = 7,
  LAYOUT_MULTI = 8,
};

/* request-body layouts (server direction) — g_req_opcodes values */
enum {
  RQ_EMPTY = 0,
  RQ_PATH = 1,
  RQ_PATH_WATCH = 2,
  RQ_CREATE = 3,
  RQ_DELETE = 4,
  RQ_SET_DATA = 5,
  RQ_SET_WATCHES = 6,
  RQ_MULTI = 7,
  RQ_ADD_WATCH = 8,
  RQ_SET_WATCHES2 = 9,
};

/* ---- byte readers (big-endian, bounds-checked) ---- */

typedef struct {
  const uint8_t *p;
  Py_ssize_t len;
  Py_ssize_t off;
  char err[192]; /* non-empty => decode error */
  int unsupported; /* protocol-valid opcode this tier has no layout
                    * for (none today): the frame is left in the
                    * buffer and the Python spec tier decodes it */
} Cursor;

static int need(Cursor *c, Py_ssize_t n) {
  if (c->off + n > c->len) {
    snprintf(c->err, sizeof(c->err),
             "need %zd bytes at offset %zd, have %zd", n, c->off,
             c->len - c->off);
    return 0;
  }
  return 1;
}

static int32_t rd_i32(Cursor *c) {
  const uint8_t *p = c->p + c->off;
  c->off += 4;
  return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                   ((uint32_t)p[2] << 8) | (uint32_t)p[3]);
}

static int64_t rd_i64(Cursor *c) {
  const uint8_t *p = c->p + c->off;
  c->off += 8;
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
  return (int64_t)v;
}

/* int-length-prefixed UTF-8 string; negative length => "" (the jute
 * empty-buffer quirk, lib/jute-buffer.js:99-100). NULL on error. */
static PyObject *rd_string(Cursor *c) {
  if (!need(c, 4)) return NULL;
  int32_t ln = rd_i32(c);
  if (ln < 0) return PyUnicode_FromStringAndSize("", 0);
  if (!need(c, ln)) return NULL;
  PyObject *s =
      PyUnicode_DecodeUTF8((const char *)c->p + c->off, ln, NULL);
  if (s == NULL) {
    /* surface as a decode error, not a raised exception */
    PyErr_Clear();
    snprintf(c->err, sizeof(c->err), "invalid utf-8 string at offset %zd",
             c->off);
    return NULL;
  }
  c->off += ln;
  return s;
}

static PyObject *rd_bytes(Cursor *c) {
  if (!need(c, 4)) return NULL;
  int32_t ln = rd_i32(c);
  if (ln < 0) return PyBytes_FromStringAndSize("", 0);
  if (!need(c, ln)) return NULL;
  PyObject *b =
      PyBytes_FromStringAndSize((const char *)c->p + c->off, ln);
  c->off += ln;
  return b;
}

/* the 68-byte Stat record in one bounds check
 * (reference: lib/zk-buffer.js:428-442).
 *
 * Stat is a NamedTuple, i.e. a tuple subclass, so the instance is
 * built through tuple's own tp_new — the exact effect of
 * `tuple.__new__(Stat, fields)` — skipping the generated Python-level
 * __new__ (which costs ~10x the tuple itself on the hot path). */
static PyObject *rd_stat(Cursor *c) {
  if (!need(c, 68)) return NULL;
  PyObject *vals = PyTuple_New(11);
  if (vals == NULL) return NULL;
#define STAT_FIELD(i, expr)                 \
  do {                                      \
    PyObject *v_ = (expr);                  \
    if (v_ == NULL) {                       \
      Py_DECREF(vals);                      \
      return NULL;                          \
    }                                       \
    PyTuple_SET_ITEM(vals, (i), v_);        \
  } while (0)
  STAT_FIELD(0, PyLong_FromLongLong(rd_i64(c)));  /* czxid */
  STAT_FIELD(1, PyLong_FromLongLong(rd_i64(c)));  /* mzxid */
  STAT_FIELD(2, PyLong_FromLongLong(rd_i64(c)));  /* ctime */
  STAT_FIELD(3, PyLong_FromLongLong(rd_i64(c)));  /* mtime */
  STAT_FIELD(4, PyLong_FromLong(rd_i32(c)));      /* version */
  STAT_FIELD(5, PyLong_FromLong(rd_i32(c)));      /* cversion */
  STAT_FIELD(6, PyLong_FromLong(rd_i32(c)));      /* aversion */
  STAT_FIELD(7, PyLong_FromLongLong(rd_i64(c)));  /* ephemeralOwner */
  STAT_FIELD(8, PyLong_FromLong(rd_i32(c)));      /* dataLength */
  STAT_FIELD(9, PyLong_FromLong(rd_i32(c)));      /* numChildren */
  STAT_FIELD(10, PyLong_FromLongLong(rd_i64(c))); /* pzxid */
#undef STAT_FIELD
  PyObject *args = PyTuple_Pack(1, vals);
  Py_DECREF(vals);
  if (args == NULL) return NULL;
  PyObject *stat =
      PyTuple_Type.tp_new((PyTypeObject *)g_stat_cls, args, NULL);
  Py_DECREF(args);
  return stat;
}

/* strict jute bool: one byte, 0 or 1 only (jute.read_bool). Returns
 * -1 on error with c->err set. */
static int rd_bool(Cursor *c) {
  if (!need(c, 1)) return -1;
  uint8_t v = c->p[c->off];
  c->off += 1;
  if (v > 1) {
    snprintf(c->err, sizeof(c->err), "bad bool byte %d", v);
    return -1;
  }
  return v;
}

/* length-prefixed ACL list (records.read_acl): [ACL(Perm, Id)].
 * NULL on error (c->err or a pending exception). */
static PyObject *rd_acl_list(Cursor *c) {
  if (!need(c, 4)) return NULL;
  int32_t n = rd_i32(c);
  if (n < 0) n = 0;
  /* wire-controlled count: each ACL entry is >= 12 bytes (perms int +
   * two length prefixes); bound before allocating */
  if (!need(c, 12 * (Py_ssize_t)n)) return NULL;
  PyObject *lst = PyList_New(n);
  if (lst == NULL) return NULL;
  for (int32_t i = 0; i < n; ++i) {
    if (!need(c, 4)) {
      Py_DECREF(lst);
      return NULL;
    }
    int32_t perms = rd_i32(c);
    PyObject *scheme = rd_string(c);
    PyObject *ident = scheme ? rd_string(c) : NULL;
    PyObject *entry = NULL;
    if (ident != NULL) {
      PyObject *id_obj =
          PyObject_CallFunction(g_id_cls, "OO", scheme, ident);
      PyObject *perm_obj =
          id_obj ? PyObject_CallFunction(g_perm_cls, "i", perms) : NULL;
      if (perm_obj != NULL)
        entry = PyObject_CallFunction(g_acl_cls, "OO", perm_obj, id_obj);
      Py_XDECREF(perm_obj);
      Py_XDECREF(id_obj);
    }
    Py_XDECREF(scheme);
    Py_XDECREF(ident);
    if (entry == NULL) {
      Py_DECREF(lst);
      return NULL;
    }
    PyList_SET_ITEM(lst, i, entry);
  }
  return lst;
}

/* dict[int] lookup helper; returns borrowed ref or NULL (no exception).
 * NULL uniformly means "treat as absent": callers take their scalar
 * fallback branch, so a failure here (key alloc under OOM included)
 * must clear the error — returning NULL with a live exception would
 * let a success value escape with the exception still set. */
static PyObject *int_key_get(PyObject *dict, long long key) {
  PyObject *k = PyLong_FromLongLong(key);
  if (k == NULL) {
    PyErr_Clear();
    return NULL;
  }
  PyObject *v = PyDict_GetItemWithError(dict, k); /* borrowed */
  Py_DECREF(k);
  if (v == NULL) PyErr_Clear();
  return v;
}

/* set pkt[key] = val, stealing val; -1 on failure (val still released) */
static int set_steal(PyObject *pkt, PyObject *key, PyObject *val) {
  if (val == NULL) return -1;
  int r = PyDict_SetItem(pkt, key, val);
  Py_DECREF(val);
  return r;
}

/* ---- one reply body ---- */

static int decode_body(Cursor *c, PyObject *pkt, int layout) {
  switch (layout) {
    case LAYOUT_EMPTY:
      return 0;
    case LAYOUT_CREATE:
      return set_steal(pkt, s_path, rd_string(c));
    case LAYOUT_STAT_ONLY:
      return set_steal(pkt, s_stat, rd_stat(c));
    case LAYOUT_GET_DATA: {
      if (set_steal(pkt, s_data, rd_bytes(c)) < 0) return -1;
      return set_steal(pkt, s_stat, rd_stat(c));
    }
    case LAYOUT_GET_CHILDREN:
    case LAYOUT_GET_CHILDREN2: {
      if (!need(c, 4)) return -1;
      int32_t n = rd_i32(c);
      if (n < 0) n = 0;
      /* the count is wire-controlled: every element needs >= 4 bytes
       * (its length prefix), so bound it by the remaining body before
       * allocating — a corrupt frame must fail as BAD_DECODE, not as a
       * multi-GB PyList_New */
      if (!need(c, 4 * (Py_ssize_t)n)) return -1;
      PyObject *lst = PyList_New(n);
      if (lst == NULL) return -1;
      for (int32_t i = 0; i < n; ++i) {
        PyObject *s = rd_string(c);
        if (s == NULL) {
          Py_DECREF(lst);
          return -1;
        }
        PyList_SET_ITEM(lst, i, s);
      }
      if (set_steal(pkt, s_children, lst) < 0) return -1;
      if (layout == LAYOUT_GET_CHILDREN2)
        return set_steal(pkt, s_stat, rd_stat(c));
      return 0;
    }
    case LAYOUT_GET_ACL: {
      if (set_steal(pkt, s_acl, rd_acl_list(c)) < 0) return -1;
      return set_steal(pkt, s_stat, rd_stat(c));
    }
    case LAYOUT_NOTIFICATION: {
      if (!need(c, 8)) return -1;
      int32_t type = rd_i32(c);
      int32_t state = rd_i32(c);
      PyObject *tname = int_key_get(g_notif_types, type);
      if (tname == NULL) {
        snprintf(c->err, sizeof(c->err), "%d is not a valid notification "
                 "type", type);
        return -1;
      }
      PyObject *sname = int_key_get(g_states, state);
      if (sname == NULL) {
        snprintf(c->err, sizeof(c->err), "%d is not a valid keeper state",
                 state);
        return -1;
      }
      if (PyDict_SetItem(pkt, s_type, tname) < 0) return -1;
      if (PyDict_SetItem(pkt, s_state, sname) < 0) return -1;
      return set_steal(pkt, s_path, rd_string(c));
    }
    case LAYOUT_MULTI: {
      /* jute MultiResponse (opcode 14): `int type | bool done | int
       * err` headers, OK results carrying the single-op reply body
       * (create: path; setData: Stat; delete/check: header only),
       * type -1 an ErrorResult whose body repeats the code,
       * terminated by a done header.  Mirrors
       * records._read_multi_resp exactly (which, like the upstream
       * client, does not re-check the terminator's type). */
      PyObject *results = PyList_New(0);
      if (results == NULL) return -1;
      for (;;) {
        if (!need(c, 9)) goto multi_fail;
        int32_t mtype = rd_i32(c);
        int done = rd_bool(c);
        if (done < 0) goto multi_fail;
        int32_t errv = rd_i32(c);
        if (done) break;
        PyObject *res = PyDict_New();
        if (res == NULL) goto multi_fail;
        int bad = 0;
        if (mtype == -1) {
          if (!need(c, 4)) {
            Py_DECREF(res);
            goto multi_fail;
          }
          (void)rd_i32(c);    /* ErrorResult body repeats the code */
          bad |= PyDict_SetItem(res, s_op, s_op_error) < 0;
          PyObject *en = int_key_get(g_err_names, errv);
          if (en != NULL) {   /* borrowed */
            bad |= PyDict_SetItem(res, s_err, en) < 0;
          } else {            /* consts.err_name's ERROR_%d shape */
            bad |= set_steal(res, s_err,
                             PyUnicode_FromFormat("ERROR_%d",
                                                  errv)) < 0;
          }
        } else if (mtype == 1) {           /* OpCode.CREATE */
          bad |= PyDict_SetItem(res, s_op, s_op_create) < 0;
          bad |= set_steal(res, s_path, rd_string(c)) < 0;
        } else if (mtype == 5) {           /* OpCode.SET_DATA */
          bad |= PyDict_SetItem(res, s_op, s_op_set_data) < 0;
          bad |= set_steal(res, s_stat, rd_stat(c)) < 0;
        } else if (mtype == 2) {           /* OpCode.DELETE */
          bad |= PyDict_SetItem(res, s_op, s_op_delete) < 0;
        } else if (mtype == 13) {          /* OpCode.CHECK */
          bad |= PyDict_SetItem(res, s_op, s_op_check) < 0;
        } else {
          snprintf(c->err, sizeof(c->err),
                   "unsupported multi result type %d", mtype);
          bad = 1;
        }
        if (bad || PyList_Append(results, res) < 0) {
          Py_DECREF(res);
          goto multi_fail;
        }
        Py_DECREF(res);
      }
      return set_steal(pkt, s_results, results);
    multi_fail:
      Py_DECREF(results);
      return -1;
    }
    default:
      snprintf(c->err, sizeof(c->err), "unknown layout %d", layout);
      return -1;
  }
}

/* ---- one frame -> packet dict (NULL + c->err / exception on error) -- */

static PyObject *decode_reply(Cursor *c, PyObject *xid_map) {
  if (!need(c, 16)) return NULL;
  int32_t xid = rd_i32(c);
  int64_t zxid = rd_i64(c);
  int32_t errc = rd_i32(c);

  PyObject *pkt = PyDict_New();
  if (pkt == NULL) return NULL;

  PyObject *opcode = NULL; /* borrowed or owned; track via owned flag */
  int opcode_owned = 0;
  switch (xid) { /* SPECIAL_XIDS (lib/zk-consts.js:135-138) */
    case -1: opcode = s_notification; break;
    case -2: opcode = s_ping; break;
    case -4: opcode = s_auth; break;
    case -8: opcode = s_set_watches; break;
    default: {
      PyObject *k = PyLong_FromLong(xid);
      if (k == NULL) goto fail;
      /* one reply per xid: pop, matching records.read_response
       * (get+del; PyDict_Pop is not public until 3.13) */
      opcode = PyDict_GetItemWithError(xid_map, k); /* borrowed */
      if (opcode == NULL) {
        Py_DECREF(k);
        if (PyErr_Occurred()) goto fail;
        snprintf(c->err, sizeof(c->err),
                 "reply xid %d matches no request", xid);
        goto fail;
      }
      Py_INCREF(opcode);
      opcode_owned = 1;
      /* punt BEFORE consuming the xid: a reply opcode this tier has
       * no body layout for (none registered today) goes back to the
       * Python spec, which pops the xid itself.  Error replies carry
       * no body, so they stay decodable here whatever the opcode. */
      if (errc == 0) {
        PyObject *layout = PyDict_GetItemWithError(g_layouts, opcode);
        if (layout == NULL) {
          Py_DECREF(k);
          if (PyErr_Occurred()) goto fail;
          snprintf(c->err, sizeof(c->err), "unsupported reply opcode");
          c->unsupported = 1;
          goto fail;
        }
      }
      if (PyDict_DelItem(xid_map, k) < 0) {
        Py_DECREF(k);
        goto fail;
      }
      Py_DECREF(k);
    }
  }

  if (set_steal(pkt, s_xid, PyLong_FromLong(xid)) < 0) goto fail;
  if (set_steal(pkt, s_zxid, PyLong_FromLongLong(zxid)) < 0) goto fail;
  PyObject *err_name = errc == 0 ? s_ok : int_key_get(g_err_names, errc);
  if (err_name != NULL) {
    if (PyDict_SetItem(pkt, s_err, err_name) < 0) goto fail;
  } else { /* unknown code -> 'ERROR_%d' (consts.err_name) */
    if (set_steal(pkt, s_err, PyUnicode_FromFormat("ERROR_%d", errc)) < 0)
      goto fail;
  }
  if (PyDict_SetItem(pkt, s_opcode, opcode) < 0) goto fail;

  if (errc == 0) {
    PyObject *layout = PyDict_GetItemWithError(g_layouts, opcode);
    if (layout == NULL) {
      if (PyErr_Occurred()) goto fail;
      snprintf(c->err, sizeof(c->err), "unsupported reply opcode");
      goto fail;
    }
    if (decode_body(c, pkt, (int)PyLong_AsLong(layout)) < 0) goto fail;
  }
  if (opcode_owned) Py_DECREF(opcode);
  return pkt;

fail:
  if (opcode_owned) Py_XDECREF(opcode);
  Py_DECREF(pkt);
  return NULL;
}

/* ---- one frame -> request dict (server direction) ---- */

static int decode_req_body(Cursor *c, PyObject *pkt, int layout) {
  switch (layout) {
    case RQ_EMPTY:
      return 0;
    case RQ_PATH:
      return set_steal(pkt, s_path, rd_string(c));
    case RQ_PATH_WATCH: {
      if (set_steal(pkt, s_path, rd_string(c)) < 0) return -1;
      int w = rd_bool(c);
      if (w < 0) return -1;
      return PyDict_SetItem(pkt, s_watch, w ? Py_True : Py_False);
    }
    case RQ_CREATE: {
      if (set_steal(pkt, s_path, rd_string(c)) < 0) return -1;
      if (set_steal(pkt, s_data, rd_bytes(c)) < 0) return -1;
      if (set_steal(pkt, s_acl, rd_acl_list(c)) < 0) return -1;
      if (!need(c, 4)) return -1;
      return set_steal(pkt, s_flags,
                       PyObject_CallFunction(g_create_flag_cls, "i",
                                             rd_i32(c)));
    }
    case RQ_DELETE: {
      if (set_steal(pkt, s_path, rd_string(c)) < 0) return -1;
      if (!need(c, 4)) return -1;
      return set_steal(pkt, s_version, PyLong_FromLong(rd_i32(c)));
    }
    case RQ_SET_DATA: {
      if (set_steal(pkt, s_path, rd_string(c)) < 0) return -1;
      if (set_steal(pkt, s_data, rd_bytes(c)) < 0) return -1;
      if (!need(c, 4)) return -1;
      return set_steal(pkt, s_version, PyLong_FromLong(rd_i32(c)));
    }
    case RQ_ADD_WATCH: {
      /* AddWatchRequest: path + AddWatchMode int (opcode 106) */
      if (set_steal(pkt, s_path, rd_string(c)) < 0) return -1;
      if (!need(c, 4)) return -1;
      return set_steal(pkt, s_mode, PyLong_FromLong(rd_i32(c)));
    }
    case RQ_SET_WATCHES:
    case RQ_SET_WATCHES2: {
      /* SET_WATCHES2 appends the two persistent lists after the
       * three legacy one-shot lists — same framing otherwise */
      int nkinds = layout == RQ_SET_WATCHES2 ? 5 : 3;
      if (!need(c, 8)) return -1;
      PyObject *rel = PyLong_FromLongLong(rd_i64(c));
      if (set_steal(pkt, s_relZxid, rel) < 0) return -1;
      PyObject *events = PyDict_New();
      if (events == NULL) return -1;
      PyObject *kinds[5] = {s_dataChanged, s_createdOrDestroyed,
                            s_childrenChanged, s_persistent,
                            s_persistentRecursive};
      for (int k = 0; k < nkinds; ++k) {
        if (!need(c, 4)) {
          Py_DECREF(events);
          return -1;
        }
        int32_t n = rd_i32(c);
        if (n < 0) n = 0;
        if (!need(c, 4 * (Py_ssize_t)n)) { /* wire-controlled count */
          Py_DECREF(events);
          return -1;
        }
        PyObject *lst = PyList_New(n);
        if (lst == NULL) {
          Py_DECREF(events);
          return -1;
        }
        for (int32_t i = 0; i < n; ++i) {
          PyObject *s = rd_string(c);
          if (s == NULL) {
            Py_DECREF(lst);
            Py_DECREF(events);
            return -1;
          }
          PyList_SET_ITEM(lst, i, s);
        }
        if (PyDict_SetItem(events, kinds[k], lst) < 0) {
          Py_DECREF(lst);
          Py_DECREF(events);
          return -1;
        }
        Py_DECREF(lst);
      }
      return set_steal(pkt, s_events, events);
    }
    case RQ_MULTI: {
      /* jute MultiTransactionRecord (opcode 14): headers as in the
       * response direction; sub-op bodies reuse the single-op
       * request layouts (create/delete/setData; check shares
       * delete's path+version shape), and the terminator's type
       * must be -1 — mirrors records._read_multi exactly. */
      PyObject *ops = PyList_New(0);
      if (ops == NULL) return -1;
      for (;;) {
        if (!need(c, 9)) goto rq_multi_fail;
        int32_t mtype = rd_i32(c);
        int done = rd_bool(c);
        if (done < 0) goto rq_multi_fail;
        (void)rd_i32(c);                  /* err: always -1 here */
        if (done) {
          if (mtype != -1) {
            snprintf(c->err, sizeof(c->err),
                     "multi terminator carries type %d", mtype);
            goto rq_multi_fail;
          }
          break;
        }
        PyObject *name;
        int sublayout;
        if (mtype == 1) {                  /* OpCode.CREATE */
          name = s_op_create;
          sublayout = RQ_CREATE;
        } else if (mtype == 2) {           /* OpCode.DELETE */
          name = s_op_delete;
          sublayout = RQ_DELETE;
        } else if (mtype == 5) {           /* OpCode.SET_DATA */
          name = s_op_set_data;
          sublayout = RQ_SET_DATA;
        } else if (mtype == 13) {          /* OpCode.CHECK */
          name = s_op_check;
          sublayout = RQ_DELETE;   /* same path+version body */
        } else {
          snprintf(c->err, sizeof(c->err),
                   "unsupported multi sub-op type %d", mtype);
          goto rq_multi_fail;
        }
        PyObject *sub = PyDict_New();
        if (sub == NULL) goto rq_multi_fail;
        if (PyDict_SetItem(sub, s_op, name) < 0 ||
            decode_req_body(c, sub, sublayout) < 0 ||
            PyList_Append(ops, sub) < 0) {
          Py_DECREF(sub);
          goto rq_multi_fail;
        }
        Py_DECREF(sub);
      }
      return set_steal(pkt, s_ops, ops);
    rq_multi_fail:
      Py_DECREF(ops);
      return -1;
    }
    default:
      snprintf(c->err, sizeof(c->err), "unknown request layout %d",
               layout);
      return -1;
  }
}

static PyObject *decode_request(Cursor *c) {
  if (!need(c, 8)) return NULL;
  int32_t xid = rd_i32(c);
  int32_t op = rd_i32(c);

  PyObject *entry = int_key_get(g_req_opcodes, op);
  if (entry == NULL) {
    /* match the Python spec's two distinct failures: a protocol-valid
     * opcode with no request reader vs a number outside the enum.  A
     * valid opcode is a PUNT, not an error: the spec tier may carry a
     * reader this tier does not — the frame walk leaves the frame in the
     * buffer and the Python path decides. */
    PyObject *known = int_key_get(g_op_names, op);
    if (known != NULL) {
      snprintf(c->err, sizeof(c->err), "unsupported opcode '%s'",
               PyUnicode_AsUTF8(known));
      c->unsupported = 1;
    } else {
      snprintf(c->err, sizeof(c->err), "%d is not a valid OpCode", op);
    }
    return NULL;
  }
  PyObject *name = PyTuple_GET_ITEM(entry, 0);   /* borrowed */
  int layout = (int)PyLong_AsLong(PyTuple_GET_ITEM(entry, 1));

  PyObject *pkt = PyDict_New();
  if (pkt == NULL) return NULL;
  if (set_steal(pkt, s_xid, PyLong_FromLong(xid)) < 0) goto fail;
  if (PyDict_SetItem(pkt, s_opcode, name) < 0) goto fail;
  if (decode_req_body(c, pkt, layout) < 0) goto fail;
  return pkt;

fail:
  Py_DECREF(pkt);
  return NULL;
}

/* ---- encode (steady state, both directions) ----------------------
 *
 * Best-effort accelerator with the Python JuteWriter as the semantic
 * spec and fallback: any unexpected shape/type/range returns NULL
 * WITHOUT setting an exception, and PacketCodec.encode re-runs the
 * Python encoder, which raises its own precise validation errors.
 * Byte-for-byte equality with the Python encoder is asserted in
 * tests/test_torch_native_ext.py. */

typedef struct {
  uint8_t *p;
  Py_ssize_t len;
  Py_ssize_t cap;
  int oom;
} WBuf;

static int wb_reserve(WBuf *w, Py_ssize_t extra) {
  if (w->len + extra <= w->cap) return 1;
  Py_ssize_t ncap = w->cap ? w->cap * 2 : 256;
  while (ncap < w->len + extra) ncap *= 2;
  uint8_t *np = (uint8_t *)PyMem_Realloc(w->p, ncap);
  if (np == NULL) {
    w->oom = 1;
    return 0;
  }
  w->p = np;
  w->cap = ncap;
  return 1;
}

static void wr_i32(WBuf *w, int32_t v) {
  if (!wb_reserve(w, 4)) return;
  w->p[w->len++] = (uint8_t)(v >> 24);
  w->p[w->len++] = (uint8_t)(v >> 16);
  w->p[w->len++] = (uint8_t)(v >> 8);
  w->p[w->len++] = (uint8_t)v;
}

static void wr_i64(WBuf *w, int64_t v) {
  if (!wb_reserve(w, 8)) return;
  for (int i = 7; i >= 0; --i) w->p[w->len++] = (uint8_t)(v >> (8 * i));
}

/* fetch pkt[key] as int64 within [lo, hi]; 0 on any mismatch */
static int get_i64(PyObject *pkt, PyObject *key, int64_t lo, int64_t hi,
                   int64_t *out) {
  PyObject *v = PyDict_GetItemWithError(pkt, key); /* borrowed */
  if (v == NULL) {
    PyErr_Clear();
    return 0;
  }
  int overflow = 0;
  long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (overflow || (ll == -1 && PyErr_Occurred())) {
    PyErr_Clear();
    return 0;
  }
  if (ll < lo || ll > hi) return 0;
  *out = ll;
  return 1;
}

/* write an int-length-prefixed utf8 string (the "" -> length -1
 * empty-buffer convention of JuteWriter.write_ustring) */
static int wr_str_obj(WBuf *w, PyObject *v) {
  if (!PyUnicode_Check(v)) return 0;
  Py_ssize_t n;
  const char *s = PyUnicode_AsUTF8AndSize(v, &n);
  if (s == NULL) {
    PyErr_Clear();
    return 0;
  }
  if (n > INT32_MAX) return 0;
  wr_i32(w, n == 0 ? -1 : (int32_t)n);
  if (n && wb_reserve(w, n)) {
    memcpy(w->p + w->len, s, n);
    w->len += n;
  }
  return 1;
}

static int wr_str_field(WBuf *w, PyObject *pkt, PyObject *key) {
  PyObject *v = PyDict_GetItemWithError(pkt, key);
  if (v == NULL) {
    PyErr_Clear();
    return 0;
  }
  return wr_str_obj(w, v);
}

/* write an int-length-prefixed byte buffer from pkt[key]
 * (empty -> length -1, lib/jute-buffer.js:127-130) */
static int wr_bytes_field(WBuf *w, PyObject *pkt, PyObject *key) {
  PyObject *v = PyDict_GetItemWithError(pkt, key);
  if (v == NULL || !PyBytes_Check(v)) {
    PyErr_Clear();
    return 0;
  }
  Py_ssize_t n = PyBytes_GET_SIZE(v);
  if (n > INT32_MAX) return 0;
  wr_i32(w, n == 0 ? -1 : (int32_t)n);
  if (n && wb_reserve(w, n)) {
    memcpy(w->p + w->len, PyBytes_AS_STRING(v), n);
    w->len += n;
  }
  return 1;
}

/* Stat from pkt[key] (an 11-tuple of ints, records.Stat) */
static int wr_stat_field(WBuf *w, PyObject *pkt, PyObject *key) {
  PyObject *v = PyDict_GetItemWithError(pkt, key);
  if (v == NULL || !PyTuple_Check(v) || PyTuple_GET_SIZE(v) != 11) {
    PyErr_Clear();
    return 0;
  }
  static const int widths[11] = {8, 8, 8, 8, 4, 4, 4, 8, 4, 4, 8};
  for (int i = 0; i < 11; ++i) {
    PyObject *f = PyTuple_GET_ITEM(v, i);
    int overflow = 0;
    long long ll = PyLong_AsLongLongAndOverflow(f, &overflow);
    if (overflow || (ll == -1 && PyErr_Occurred())) {
      PyErr_Clear();
      return 0;
    }
    if (widths[i] == 4) {
      if (ll < INT32_MIN || ll > INT32_MAX) return 0;
      wr_i32(w, (int32_t)ll);
    } else {
      wr_i64(w, ll);
    }
  }
  return 1;
}

/* name -> enum int via a reverse dict; -1 on miss */
static int rev_lookup(PyObject *dict, PyObject *name, int64_t *out) {
  PyObject *v = PyDict_GetItemWithError(dict, name);
  if (v == NULL) {
    PyErr_Clear();
    return 0;
  }
  long long ll = PyLong_AsLongLong(v);
  if (ll == -1 && PyErr_Occurred()) {
    PyErr_Clear();
    return 0;
  }
  *out = ll;
  return 1;
}

static PyObject *g_err_codes;   /* dict str -> int (reverse ErrCode) */
static PyObject *g_notif_codes; /* dict str -> int */
static PyObject *g_state_codes; /* dict str -> int */
static PyObject *g_op_codes;    /* dict str -> int (full OpCode) */

/* response body by layout; 1 ok, 0 -> fall back to Python */
static int enc_resp_body(WBuf *w, PyObject *pkt, int layout) {
  switch (layout) {
    case LAYOUT_EMPTY:
      return 1;
    case LAYOUT_CREATE:
      return wr_str_field(w, pkt, s_path);
    case LAYOUT_STAT_ONLY:
      return wr_stat_field(w, pkt, s_stat);
    case LAYOUT_GET_DATA:
      return wr_bytes_field(w, pkt, s_data)
             && wr_stat_field(w, pkt, s_stat);
    case LAYOUT_GET_CHILDREN:
    case LAYOUT_GET_CHILDREN2: {
      PyObject *lst = PyDict_GetItemWithError(pkt, s_children);
      if (lst == NULL || !PyList_Check(lst)) {
        PyErr_Clear();
        return 0;
      }
      Py_ssize_t n = PyList_GET_SIZE(lst);
      if (n > INT32_MAX) return 0;
      wr_i32(w, (int32_t)n);
      for (Py_ssize_t i = 0; i < n; ++i) {
        if (!wr_str_obj(w, PyList_GET_ITEM(lst, i))) return 0;
      }
      if (layout == LAYOUT_GET_CHILDREN2)
        return wr_stat_field(w, pkt, s_stat);
      return 1;
    }
    case LAYOUT_NOTIFICATION: {
      PyObject *t = PyDict_GetItemWithError(pkt, s_type);
      PyObject *st = t ? PyDict_GetItemWithError(pkt, s_state) : NULL;
      int64_t tv, sv;
      if (st == NULL || !rev_lookup(g_notif_codes, t, &tv)
          || !rev_lookup(g_state_codes, st, &sv)) {
        PyErr_Clear();
        return 0;
      }
      wr_i32(w, (int32_t)tv);
      wr_i32(w, (int32_t)sv);
      return wr_str_field(w, pkt, s_path);
    }
    default: /* GET_ACL responses are rare; Python handles them */
      return 0;
  }
}

/* request body by layout; 1 ok, 0 -> fall back */
static int enc_req_body(WBuf *w, PyObject *pkt, int layout) {
  switch (layout) {
    case RQ_EMPTY:
      return 1;
    case RQ_PATH:
      return wr_str_field(w, pkt, s_path);
    case RQ_PATH_WATCH: {
      if (!wr_str_field(w, pkt, s_path)) return 0;
      PyObject *v = PyDict_GetItemWithError(pkt, s_watch);
      if (v == NULL || !PyBool_Check(v)) {
        PyErr_Clear();
        return 0;
      }
      if (wb_reserve(w, 1)) w->p[w->len++] = v == Py_True ? 1 : 0;
      return 1;
    }
    case RQ_DELETE: {
      int64_t ver;
      if (!wr_str_field(w, pkt, s_path)
          || !get_i64(pkt, s_version, INT32_MIN, INT32_MAX, &ver))
        return 0;
      wr_i32(w, (int32_t)ver);
      return 1;
    }
    case RQ_SET_DATA: {
      int64_t ver;
      if (!wr_str_field(w, pkt, s_path)
          || !wr_bytes_field(w, pkt, s_data)
          || !get_i64(pkt, s_version, INT32_MIN, INT32_MAX, &ver))
        return 0;
      wr_i32(w, (int32_t)ver);
      return 1;
    }
    case RQ_CREATE: {
      /* path, data, ACL list (count; perms/scheme/id per entry —
       * records.write_acl), flags (CreateFlag coerces; default 0) */
      if (!wr_str_field(w, pkt, s_path)
          || !wr_bytes_field(w, pkt, s_data))
        return 0;
      PyObject *acl = PyDict_GetItemWithError(pkt, s_acl);
      if (acl == NULL || !(PyList_Check(acl) || PyTuple_Check(acl))) {
        PyErr_Clear();
        return 0;
      }
      Py_INCREF(acl); /* GetAttr below may run arbitrary Python that
                       * drops the packet's reference */
      Py_ssize_t n = PySequence_Fast_GET_SIZE(acl);
      if (n > INT32_MAX) {
        Py_DECREF(acl);
        return 0;
      }
      wr_i32(w, (int32_t)n);
      for (Py_ssize_t i = 0; i < n; ++i) {
        /* a list can shrink under a hostile __getattr__ */
        if (i >= PySequence_Fast_GET_SIZE(acl)) {
          Py_DECREF(acl);
          return 0;
        }
        PyObject *entry = PySequence_Fast_GET_ITEM(acl, i);
        Py_INCREF(entry);
        PyObject *perms = PyObject_GetAttr(entry, s_perms);
        PyObject *idobj = perms ? PyObject_GetAttr(entry, s_id_attr)
                                : NULL;
        PyObject *scheme = idobj ? PyObject_GetAttr(idobj, s_scheme)
                                 : NULL;
        PyObject *ident = scheme ? PyObject_GetAttr(idobj, s_id_attr)
                                 : NULL;
        int ok = 0;
        if (ident != NULL) {
          int overflow = 0;
          long long pv = PyLong_AsLongLongAndOverflow(perms, &overflow);
          if (!overflow && !(pv == -1 && PyErr_Occurred())
              && pv >= INT32_MIN && pv <= INT32_MAX) {
            wr_i32(w, (int32_t)pv);
            ok = wr_str_obj(w, scheme) && wr_str_obj(w, ident);
          }
        }
        PyErr_Clear();
        Py_XDECREF(perms);
        Py_XDECREF(idobj);
        Py_XDECREF(scheme);
        Py_XDECREF(ident);
        Py_DECREF(entry);
        if (!ok) {
          Py_DECREF(acl);
          return 0;
        }
      }
      Py_DECREF(acl);
      /* flags: missing defaults to 0; negatives fall back — the
       * Python spec normalizes them through CreateFlag (e.g. -1
       * becomes 3), which the verbatim C write would diverge from */
      int64_t flags = 0;
      PyObject *fv = PyDict_GetItemWithError(pkt, s_flags);
      if (fv != NULL) {
        int overflow = 0;
        long long ll = PyLong_AsLongLongAndOverflow(fv, &overflow);
        if (overflow || (ll == -1 && PyErr_Occurred())) {
          PyErr_Clear();
          return 0;
        }
        if (ll < 0 || ll > INT32_MAX) return 0;
        flags = ll;
      } else {
        PyErr_Clear();
      }
      wr_i32(w, (int32_t)flags);
      return 1;
    }
    case RQ_ADD_WATCH: {
      /* only the two defined AddWatchMode values encode verbatim;
       * anything else falls back so the Python spec raises its own
       * validation error */
      int64_t mode;
      if (!wr_str_field(w, pkt, s_path)
          || !get_i64(pkt, s_mode, 0, 1, &mode))
        return 0;
      wr_i32(w, (int32_t)mode);
      return 1;
    }
    default: /* SET_WATCHES/2 are resume-time-rare; Python handles them */
      return 0;
  }
}

/* shared: header + body + length prefix -> bytes (or NULL=fall back) */
static PyObject *encode_framed(PyObject *pkt, int is_request) {
  WBuf w = {NULL, 0, 0, 0};
  wr_i32(&w, 0); /* length prefix slot */

  int64_t xid;
  if (!get_i64(pkt, s_xid, INT32_MIN, INT32_MAX, &xid)) goto fallback;
  wr_i32(&w, (int32_t)xid);

  PyObject *op = PyDict_GetItemWithError(pkt, s_opcode);
  if (op == NULL || !PyUnicode_Check(op)) {
    PyErr_Clear();
    goto fallback;
  }

  if (is_request) {
    int64_t opnum;
    PyObject *entry;
    if (!rev_lookup(g_op_codes, op, &opnum)) goto fallback;
    wr_i32(&w, (int32_t)opnum);
    /* layout via the request table (keyed by opcode number) */
    entry = int_key_get(g_req_opcodes, opnum);
    if (entry == NULL) goto fallback;
    if (!enc_req_body(&w, pkt,
                      (int)PyLong_AsLong(PyTuple_GET_ITEM(entry, 1))))
      goto fallback;
  } else {
    int64_t zxid, errnum = 0;
    if (!get_i64(pkt, s_zxid, INT64_MIN, INT64_MAX, &zxid))
      goto fallback;
    wr_i64(&w, zxid);
    PyObject *err = PyDict_GetItemWithError(pkt, s_err);
    if (err == NULL) { /* write_response defaults missing err to OK */
      PyErr_Clear();
    } else if (!rev_lookup(g_err_codes, err, &errnum)) {
      goto fallback;
    }
    wr_i32(&w, (int32_t)errnum);
    if (errnum == 0) {
      PyObject *layout = PyDict_GetItemWithError(g_layouts, op);
      if (layout == NULL) {
        PyErr_Clear();
        goto fallback;
      }
      if (!enc_resp_body(&w, pkt, (int)PyLong_AsLong(layout)))
        goto fallback;
    }
  }

  if (w.oom) goto fallback;
  if (w.len - 4 > INT32_MAX) goto fallback; /* Python raises properly */
  {
    int32_t body_len = (int32_t)(w.len - 4);
    w.p[0] = (uint8_t)(body_len >> 24);
    w.p[1] = (uint8_t)(body_len >> 16);
    w.p[2] = (uint8_t)(body_len >> 8);
    w.p[3] = (uint8_t)body_len;
    PyObject *out =
        PyBytes_FromStringAndSize((const char *)w.p, w.len);
    PyMem_Free(w.p);
    return out; /* NULL here means real OOM; exception is set */
  }

fallback:
  PyMem_Free(w.p);
  Py_RETURN_NONE; /* sentinel: caller uses the Python encoder */
}

static PyObject *py_encode_request(PyObject *self, PyObject *args) {
  PyObject *pkt;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &pkt)) return NULL;
  if (g_op_codes == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "setup() not called");
    return NULL;
  }
  return encode_framed(pkt, 1);
}

static PyObject *py_encode_response(PyObject *self, PyObject *args) {
  PyObject *pkt;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &pkt)) return NULL;
  if (g_op_codes == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "setup() not called");
    return NULL;
  }
  return encode_framed(pkt, 0);
}

/* ---- module functions ---- */

static PyObject *py_setup(PyObject *self, PyObject *args) {
  PyObject *stat_cls, *acl_cls, *id_cls, *perm_cls, *create_flag_cls,
      *err_names, *notif_types, *states, *layouts, *req_opcodes,
      *op_names, *err_codes, *notif_codes, *state_codes, *op_codes;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOOO", &stat_cls, &acl_cls,
                        &id_cls, &perm_cls, &create_flag_cls,
                        &err_names, &notif_types, &states, &layouts,
                        &req_opcodes, &op_names, &err_codes,
                        &notif_codes, &state_codes, &op_codes))
    return NULL;
  /* rd_stat builds instances through tuple's tp_new */
  if (!PyType_Check(stat_cls) ||
      !PyType_IsSubtype((PyTypeObject *)stat_cls, &PyTuple_Type)) {
    PyErr_SetString(PyExc_TypeError, "Stat must be a tuple subclass");
    return NULL;
  }
  Py_INCREF(stat_cls); Py_XSETREF(g_stat_cls, stat_cls);
  Py_INCREF(acl_cls); Py_XSETREF(g_acl_cls, acl_cls);
  Py_INCREF(id_cls); Py_XSETREF(g_id_cls, id_cls);
  Py_INCREF(perm_cls); Py_XSETREF(g_perm_cls, perm_cls);
  Py_INCREF(create_flag_cls);
  Py_XSETREF(g_create_flag_cls, create_flag_cls);
  Py_INCREF(err_names); Py_XSETREF(g_err_names, err_names);
  Py_INCREF(notif_types); Py_XSETREF(g_notif_types, notif_types);
  Py_INCREF(states); Py_XSETREF(g_states, states);
  Py_INCREF(layouts); Py_XSETREF(g_layouts, layouts);
  Py_INCREF(req_opcodes); Py_XSETREF(g_req_opcodes, req_opcodes);
  Py_INCREF(op_names); Py_XSETREF(g_op_names, op_names);
  Py_INCREF(err_codes); Py_XSETREF(g_err_codes, err_codes);
  Py_INCREF(notif_codes); Py_XSETREF(g_notif_codes, notif_codes);
  Py_INCREF(state_codes); Py_XSETREF(g_state_codes, state_codes);
  Py_INCREF(op_codes); Py_XSETREF(g_op_codes, op_codes);
  Py_RETURN_NONE;
}

/* shared frame walk: slice complete frames, decode each body via the
 * reply (xid_map != NULL) or request decoder, with the PacketCodec
 * error contract.  Consumes/releases `view`. */
static PyObject *decode_stream(Py_buffer view, PyObject *xid_map,
                               int max_packet) {
  const char *what = xid_map != NULL ? "Response" : "Request";
  if (g_stat_cls == NULL) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_RuntimeError, "setup() not called");
    return NULL;
  }

  const uint8_t *buf = (const uint8_t *)view.buf;
  Py_ssize_t len = view.len;

  PyObject *pkts = PyList_New(0);
  if (pkts == NULL) {
    PyBuffer_Release(&view);
    return NULL;
  }

  const char *err_kind = NULL;
  char err_msg[256] = {0};
  Py_ssize_t consumed = 0;

  /* pass 1: frame boundaries (so a bad prefix drops earlier frames
   * exactly like FrameDecoder.feed raising mid-scan) */
  Py_ssize_t off = 0, end_of_frames = 0;
  while (len - off >= 4) {
    int32_t ln = (int32_t)(((uint32_t)buf[off] << 24) |
                           ((uint32_t)buf[off + 1] << 16) |
                           ((uint32_t)buf[off + 2] << 8) |
                           (uint32_t)buf[off + 3]);
    if (ln < 0 || ln > max_packet) {
      err_kind = "BAD_LENGTH";
      snprintf(err_msg, sizeof(err_msg), "Invalid ZK packet length %d",
               ln);
      consumed = off;
      goto done;
    }
    if (len - off < 4 + (Py_ssize_t)ln) break;
    off += 4 + ln;
    end_of_frames = off;
  }
  consumed = end_of_frames;

  /* pass 2: decode each frame body */
  off = 0;
  while (off < end_of_frames) {
    int32_t ln = (int32_t)(((uint32_t)buf[off] << 24) |
                           ((uint32_t)buf[off + 1] << 16) |
                           ((uint32_t)buf[off + 2] << 8) |
                           (uint32_t)buf[off + 3]);
    Cursor c = {buf + off + 4, ln, 0, {0}};
    PyObject *pkt = xid_map != NULL ? decode_reply(&c, xid_map)
                                    : decode_request(&c);
    if (pkt == NULL) {
      if (PyErr_Occurred()) { /* real exception (OOM etc.) */
        Py_DECREF(pkts);
        PyBuffer_Release(&view);
        return NULL;
      }
      if (c.unsupported) {
        /* valid frame, no layout in this tier: leave it (and
         * everything after it) in the buffer for the Python spec
         * tier — consumed stops at the frame boundary */
        err_kind = "UNSUPPORTED";
        snprintf(err_msg, sizeof(err_msg), "%s", c.err);
        consumed = off;
        goto done;
      }
      err_kind = "BAD_DECODE";
      snprintf(err_msg, sizeof(err_msg), "Failed to decode %s: %s",
               what, c.err);
      goto done;
    }
    if (PyList_Append(pkts, pkt) < 0) {
      Py_DECREF(pkt);
      Py_DECREF(pkts);
      PyBuffer_Release(&view);
      return NULL;
    }
    Py_DECREF(pkt);
    off += 4 + ln;
  }

done:
  PyBuffer_Release(&view);
  PyObject *ret =
      err_kind == NULL
          ? Py_BuildValue("(OnOO)", pkts, consumed, Py_None, Py_None)
          : Py_BuildValue("(Onss)", pkts, consumed, err_kind, err_msg);
  Py_DECREF(pkts); /* BuildValue's "O" took its own reference */
  return ret;
}

static PyObject *py_decode_responses(PyObject *self, PyObject *args) {
  Py_buffer view;
  PyObject *xid_map;
  int max_packet;
  if (!PyArg_ParseTuple(args, "y*O!i", &view, &PyDict_Type, &xid_map,
                        &max_packet))
    return NULL;
  return decode_stream(view, xid_map, max_packet);
}

static PyObject *py_decode_requests(PyObject *self, PyObject *args) {
  Py_buffer view;
  int max_packet;
  if (!PyArg_ParseTuple(args, "y*i", &view, &max_packet)) return NULL;
  return decode_stream(view, NULL, max_packet);
}

static PyObject *py_abi_version(PyObject *self, PyObject *noargs) {
  return PyLong_FromLong(ZKWIRE_EXT_TORCH_ABI);
}

/* CRC32C (Castagnoli, reflected 0x82F63B78) for the write-ahead-log
 * record framing (server/persist.py).  Table-driven and
 * portable; the pure-Python table walk is the spec and the fallback,
 * A/B-tested equal in tests/test_torch_wal.py.  ~60x the Python loop on
 * the ~100-byte record bodies the WAL appends per committed txn. */
static uint32_t crc32c_table[256];

static void crc32c_table_init(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    crc32c_table[i] = c;
  }
}

static PyObject *py_crc32c(PyObject *self, PyObject *args) {
  Py_buffer buf;
  unsigned int seed = 0;
  if (!PyArg_ParseTuple(args, "y*|I", &buf, &seed)) return NULL;
  uint32_t c = seed ^ 0xFFFFFFFFu;
  const unsigned char *p = (const unsigned char *)buf.buf;
  Py_ssize_t n = buf.len;
  for (Py_ssize_t i = 0; i < n; i++)
    c = crc32c_table[(c ^ p[i]) & 0xFFu] ^ (c >> 8);
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(c ^ 0xFFFFFFFFu);
}

/* ---- batched-syscall transport tier (io/transport.py) ----------------
 *
 * The deferred join-and-write boundary of the outbound plane: one C
 * call per corked tick takes every dirty connection's frame list and
 * moves the bytes to the kernel without materializing an intermediate
 * joined Python bytes per connection.
 *
 *   submit_writev(fds, chunklists)     parallel arrays: fds[i] gets
 *     -> [written_or_negative_errno, ...]   chunklists[i]; one
 *        writev(2) per entry (vectored: the "join" is the iovec
 *        array; flat arrays skip a tuple per entry on the hot path)
 *
 *   uring_create(depth) -> capsule          io_uring ring, or OSError
 *   uring_submit(capsule, fds, chunklists)
 *     -> ([sent_or_negative_errno, ...], enter_syscalls)
 *        ONE chained SQE submission (IORING_OP_SENDMSG + MSG_DONTWAIT
 *        per entry, iovec-joined) covering the whole batch; the call
 *        submits and reaps synchronously, so buffer lifetimes are the
 *        caller's references and per-fd ordering is submission order.
 *   uring_close(capsule)
 *
 * The Python tier (io/transport.py) holds the fallback loop
 * (os.writev per entry) and the capability probe; CPython ignores
 * SIGPIPE, so a peer-reset socket surfaces as -EPIPE in the result
 * slot, never a signal. */

#define ZK_IOV_CAP 1024 /* IOV_MAX floor: writev waves per entry */

#ifndef MSG_NOSIGNAL
#define MSG_NOSIGNAL 0
#endif

/* One entry's vectored write: returns bytes written, or -errno when
 * nothing was written.  Partial waves stop the loop (the caller
 * re-routes the remainder through the asyncio transport).  The
 * single-chunk case — the fan-out shape: one pre-joined notification
 * batch per connection — takes send(2), which skips the kernel's
 * iovec import; non-sockets fall through to writev. */
static long long writev_chunks(int fd, struct iovec *iov,
                               Py_ssize_t nch) {
  if (nch == 1) {
    ssize_t r;
    do {
      r = send(fd, iov[0].iov_base, iov[0].iov_len, MSG_NOSIGNAL);
    } while (r < 0 && errno == EINTR);
    if (r >= 0) return (long long)r;
    if (errno != ENOTSOCK) return -(long long)errno;
  }
  long long written = 0;
  Py_ssize_t base = 0;
  while (base < nch) {
    int cnt = (nch - base) > ZK_IOV_CAP ? ZK_IOV_CAP
                                        : (int)(nch - base);
    ssize_t r;
    do {
      r = writev(fd, iov + base, cnt);
    } while (r < 0 && errno == EINTR);
    if (r < 0) {
      if (written == 0) return -(long long)errno;
      break;
    }
    written += (long long)r;
    long long wave = 0;
    for (int k = 0; k < cnt; k++)
      wave += (long long)iov[base + k].iov_len;
    if ((long long)r < wave) break;
    base += cnt;
  }
  return written;
}

/* Acquire one entry's chunk list as (Py_buffer[], iovec[]).  Returns
 * the chunk count, or -1 with a Python error set.  *bufs_out buffers
 * are acquired [0, count) and must be released by the caller. */
static Py_ssize_t acquire_iov(PyObject *chunks, Py_buffer **bufs_out,
                              struct iovec **iov_out,
                              PyObject **fast_out) {
  PyObject *cf = PySequence_Fast(chunks, "chunks must be a sequence");
  if (!cf) return -1;
  Py_ssize_t nch = PySequence_Fast_GET_SIZE(cf);
  Py_buffer *bufs = PyMem_Malloc(sizeof(Py_buffer) * (nch ? nch : 1));
  struct iovec *iov =
      PyMem_Malloc(sizeof(struct iovec) * (nch ? nch : 1));
  if (!bufs || !iov) {
    PyMem_Free(bufs);
    PyMem_Free(iov);
    Py_DECREF(cf);
    PyErr_NoMemory();
    return -1;
  }
  for (Py_ssize_t j = 0; j < nch; j++) {
    if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(cf, j), &bufs[j],
                           PyBUF_SIMPLE) < 0) {
      while (j-- > 0) PyBuffer_Release(&bufs[j]);
      PyMem_Free(bufs);
      PyMem_Free(iov);
      Py_DECREF(cf);
      return -1;
    }
    iov[j].iov_base = bufs[j].buf;
    iov[j].iov_len = (size_t)bufs[j].len;
  }
  *bufs_out = bufs;
  *iov_out = iov;
  *fast_out = cf;
  return nch;
}

static void release_iov(Py_buffer *bufs, struct iovec *iov,
                        PyObject *fast, Py_ssize_t nch) {
  for (Py_ssize_t j = 0; j < nch; j++) PyBuffer_Release(&bufs[j]);
  PyMem_Free(bufs);
  PyMem_Free(iov);
  Py_DECREF(fast);
}

/* Chunk counts per connection per tick are tiny in steady state (a
 * corked tick's frames arrive as ONE pre-joined plane flush, a
 * fan-out adds one more): a stack-resident iovec covers the common
 * case with zero allocation per connection. */
#define ZK_STACK_IOV 8

/* Fetch entry i of the parallel (fds, chunklists) batch arrays.
 * Returns 0 on success with *fd_out / *chunks_out set, -1 with a
 * Python error set. */
static int batch_entry(PyObject *fds, PyObject *chunklists,
                       Py_ssize_t i, int *fd_out,
                       PyObject **chunks_out) {
  long fd = PyLong_AsLong(PySequence_Fast_GET_ITEM(fds, i));
  if (fd == -1 && PyErr_Occurred()) return -1;
  *fd_out = (int)fd;
  *chunks_out = PySequence_Fast_GET_ITEM(chunklists, i);
  return 0;
}

static PyObject *py_submit_writev(PyObject *self, PyObject *args) {
  PyObject *fds_obj, *cl_obj;
  if (!PyArg_ParseTuple(args, "OO", &fds_obj, &cl_obj)) return NULL;
  PyObject *fast = PySequence_Fast(fds_obj, "fds must be a sequence");
  if (!fast) return NULL;
  PyObject *clfast =
      PySequence_Fast(cl_obj, "chunklists must be a sequence");
  if (!clfast) {
    Py_DECREF(fast);
    return NULL;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  if (PySequence_Fast_GET_SIZE(clfast) != n) {
    PyErr_SetString(PyExc_ValueError, "fds/chunklists length mismatch");
    Py_DECREF(fast);
    Py_DECREF(clfast);
    return NULL;
  }
  PyObject *results = PyList_New(n);
  if (!results) {
    Py_DECREF(fast);
    Py_DECREF(clfast);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    int fd;
    PyObject *chunks;
    if (batch_entry(fast, clfast, i, &fd, &chunks) < 0) goto fail;
    Py_buffer sbufs[ZK_STACK_IOV];
    struct iovec siov[ZK_STACK_IOV];
    Py_buffer *bufs = sbufs;
    struct iovec *iov = siov;
    PyObject *cf;
    Py_ssize_t nch;
    if (PyList_CheckExact(chunks)
        && PyList_GET_SIZE(chunks) <= ZK_STACK_IOV) {
      /* the hot path: small chunk list, stack arrays, no mallocs */
      nch = PyList_GET_SIZE(chunks);
      cf = NULL;
      Py_ssize_t j;
      for (j = 0; j < nch; j++) {
        if (PyObject_GetBuffer(PyList_GET_ITEM(chunks, j), &bufs[j],
                               PyBUF_SIMPLE) < 0)
          break;
        iov[j].iov_base = bufs[j].buf;
        iov[j].iov_len = (size_t)bufs[j].len;
      }
      if (j < nch) {
        while (j-- > 0) PyBuffer_Release(&bufs[j]);
        goto fail;
      }
    } else {
      nch = acquire_iov(chunks, &bufs, &iov, &cf);
      if (nch < 0) goto fail;
    }
    long long res = nch ? writev_chunks(fd, iov, nch) : 0;
    if (cf != NULL) {
      release_iov(bufs, iov, cf, nch);
    } else {
      for (Py_ssize_t j = 0; j < nch; j++) PyBuffer_Release(&bufs[j]);
    }
    PyObject *val = PyLong_FromLongLong(res);
    if (!val) goto fail;
    PyList_SET_ITEM(results, i, val);
  }
  Py_DECREF(fast);
  Py_DECREF(clfast);
  return results;
fail:
  Py_DECREF(fast);
  Py_DECREF(clfast);
  Py_DECREF(results);
  return NULL;
}

/* ---- batched receive drain (io/ingress.py) --------------------------
 *
 * The receive-direction twin of submit_writev: one C call per dirty
 * ingress shard per tick takes the shard's readable fds and moves
 * every connection's pending bytes out of the kernel — one recv(2)
 * per fd inside the call (TCP has no cross-fd recvmmsg; the Python-
 * level submission count is what drops to O(dirty shards)), zero
 * per-fd Python dispatch, zero intermediate buffers.
 *
 *   drain_recv(fds, bufsize)
 *     -> [bytes | -errno, ...]   per fd: the received bytes (b'' =
 *        EOF, exactly what a StreamReader read returns at EOF), or
 *        a negative errno (-EAGAIN = readiness raced an earlier
 *        drain; the caller skips, never closes).
 *
 * Buffers are allocated at bufsize and resized down to the received
 * length — the common short read costs one shrink, never a copy of
 * bytes that were not received. */

static PyObject *py_drain_recv(PyObject *self, PyObject *args) {
  PyObject *fds_obj;
  int bufsize;
  if (!PyArg_ParseTuple(args, "Oi", &fds_obj, &bufsize)) return NULL;
  if (bufsize <= 0) {
    PyErr_SetString(PyExc_ValueError, "bufsize must be positive");
    return NULL;
  }
  PyObject *fast = PySequence_Fast(fds_obj, "fds must be a sequence");
  if (!fast) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject *results = PyList_New(n);
  if (!results) {
    Py_DECREF(fast);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    long fd = PyLong_AsLong(PySequence_Fast_GET_ITEM(fast, i));
    if (fd == -1 && PyErr_Occurred()) goto fail;
    PyObject *buf = PyBytes_FromStringAndSize(NULL, bufsize);
    if (!buf) goto fail;
    ssize_t r;
    do {
      r = recv((int)fd, PyBytes_AS_STRING(buf), (size_t)bufsize,
               MSG_DONTWAIT);
    } while (r < 0 && errno == EINTR);
    if (r < 0 && errno == ENOTSOCK) {
      /* non-socket fd (test double over a pipe): plain read — the
       * caller's fds are already non-blocking */
      do {
        r = read((int)fd, PyBytes_AS_STRING(buf), (size_t)bufsize);
      } while (r < 0 && errno == EINTR);
    }
    if (r < 0) {
      Py_DECREF(buf);
      PyObject *val = PyLong_FromLong(-(long)errno);
      if (!val) goto fail;
      PyList_SET_ITEM(results, i, val);
      continue;
    }
    if (r < (ssize_t)bufsize && _PyBytes_Resize(&buf, r) < 0)
      goto fail;
    PyList_SET_ITEM(results, i, buf);
  }
  Py_DECREF(fast);
  return results;
fail:
  Py_DECREF(fast);
  Py_DECREF(results);
  return NULL;
}

#ifdef __linux__

/* io_uring ABI, declared locally: this image's kernel headers may
 * predate io_uring entirely (the runtime probe decides availability,
 * the build must always succeed).  Layouts are the stable v5.1 ABI. */

#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#endif
#ifndef __NR_io_uring_enter
#define __NR_io_uring_enter 426
#endif

#define ZK_IORING_OFF_SQ_RING 0ULL
#define ZK_IORING_OFF_CQ_RING 0x8000000ULL
#define ZK_IORING_OFF_SQES 0x10000000ULL
#define ZK_IORING_ENTER_GETEVENTS 1u
#define ZK_IORING_FEAT_SINGLE_MMAP 1u
#define ZK_IORING_OP_SENDMSG 9

#ifndef MSG_NOSIGNAL
#define MSG_NOSIGNAL 0
#endif

struct zk_sqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, flags, dropped, array,
      resv1;
  uint64_t resv2;
};

struct zk_cqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, overflow, cqes;
  uint64_t resv[2];
};

struct zk_uring_params {
  uint32_t sq_entries, cq_entries, flags, sq_thread_cpu,
      sq_thread_idle, features, wq_fd, resv[3];
  struct zk_sqring_offsets sq_off;
  struct zk_cqring_offsets cq_off;
};

struct zk_sqe { /* 64 bytes */
  uint8_t opcode, flags;
  uint16_t ioprio;
  int32_t fd;
  uint64_t off;
  uint64_t addr;
  uint32_t len;
  uint32_t msg_flags;
  uint64_t user_data;
  uint64_t pad[3];
};

struct zk_cqe {
  uint64_t user_data;
  int32_t res;
  uint32_t flags;
};

typedef struct {
  int ring_fd;
  uint64_t gen; /* submission generation: stamps user_data so a CQE
                 * from an abandoned wave (enter failure after partial
                 * completion) can never be attributed to a later
                 * wave's entry */
  unsigned sq_entries, cq_entries;
  unsigned char *sq_ptr;
  size_t sq_sz;
  unsigned char *cq_ptr;
  size_t cq_sz;
  int single_mmap;
  struct zk_sqe *sqes;
  size_t sqes_sz;
  unsigned *sq_head, *sq_tail, *sq_mask, *sq_array;
  unsigned *cq_head, *cq_tail, *cq_mask;
  struct zk_cqe *cqarr;
} zk_uring;

static void uring_free(zk_uring *u) {
  if (!u) return;
  if (u->sq_ptr && u->sq_ptr != MAP_FAILED) munmap(u->sq_ptr, u->sq_sz);
  if (!u->single_mmap && u->cq_ptr && u->cq_ptr != MAP_FAILED)
    munmap(u->cq_ptr, u->cq_sz);
  if (u->sqes && (void *)u->sqes != MAP_FAILED)
    munmap(u->sqes, u->sqes_sz);
  if (u->ring_fd >= 0) close(u->ring_fd);
  PyMem_Free(u);
}

static zk_uring uring_closed; /* sentinel: ring explicitly closed */

static void uring_capsule_destroy(PyObject *cap) {
  zk_uring *u = PyCapsule_GetPointer(cap, "zkwire.uring");
  if (u && u != &uring_closed) uring_free(u);
}

static PyObject *py_uring_create(PyObject *self, PyObject *args) {
  unsigned depth = 256;
  if (!PyArg_ParseTuple(args, "|I", &depth)) return NULL;
  struct zk_uring_params p;
  memset(&p, 0, sizeof(p));
  int fd = (int)syscall(__NR_io_uring_setup, depth, &p);
  if (fd < 0) return PyErr_SetFromErrno(PyExc_OSError);
  zk_uring *u = PyMem_Calloc(1, sizeof(zk_uring));
  if (!u) {
    close(fd);
    return PyErr_NoMemory();
  }
  u->ring_fd = fd;
  u->sq_entries = p.sq_entries;
  u->cq_entries = p.cq_entries;
  u->sq_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  u->cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(struct zk_cqe);
  u->single_mmap = (p.features & ZK_IORING_FEAT_SINGLE_MMAP) != 0;
  if (u->single_mmap) {
    if (u->cq_sz > u->sq_sz) u->sq_sz = u->cq_sz;
    u->cq_sz = u->sq_sz;
  }
  u->sq_ptr = mmap(NULL, u->sq_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, ZK_IORING_OFF_SQ_RING);
  u->cq_ptr = u->single_mmap
                  ? u->sq_ptr
                  : mmap(NULL, u->cq_sz, PROT_READ | PROT_WRITE,
                         MAP_SHARED | MAP_POPULATE, fd,
                         ZK_IORING_OFF_CQ_RING);
  u->sqes_sz = p.sq_entries * sizeof(struct zk_sqe);
  u->sqes = mmap(NULL, u->sqes_sz, PROT_READ | PROT_WRITE,
                 MAP_SHARED | MAP_POPULATE, fd, ZK_IORING_OFF_SQES);
  if (u->sq_ptr == MAP_FAILED || u->cq_ptr == MAP_FAILED ||
      (void *)u->sqes == MAP_FAILED) {
    PyErr_SetFromErrno(PyExc_OSError);
    uring_free(u);
    return NULL;
  }
  u->sq_head = (unsigned *)(u->sq_ptr + p.sq_off.head);
  u->sq_tail = (unsigned *)(u->sq_ptr + p.sq_off.tail);
  u->sq_mask = (unsigned *)(u->sq_ptr + p.sq_off.ring_mask);
  u->sq_array = (unsigned *)(u->sq_ptr + p.sq_off.array);
  u->cq_head = (unsigned *)(u->cq_ptr + p.cq_off.head);
  u->cq_tail = (unsigned *)(u->cq_ptr + p.cq_off.tail);
  u->cq_mask = (unsigned *)(u->cq_ptr + p.cq_off.ring_mask);
  u->cqarr = (struct zk_cqe *)(u->cq_ptr + p.cq_off.cqes);
  PyObject *cap =
      PyCapsule_New(u, "zkwire.uring", uring_capsule_destroy);
  if (!cap) uring_free(u);
  return cap;
}

static zk_uring *uring_from_capsule(PyObject *cap) {
  zk_uring *u = (zk_uring *)PyCapsule_GetPointer(cap, "zkwire.uring");
  if (u == &uring_closed) {
    PyErr_SetString(PyExc_ValueError, "uring already closed");
    return NULL;
  }
  return u;
}

static PyObject *py_uring_submit(PyObject *self, PyObject *args) {
  PyObject *cap, *fds_obj, *cl_obj;
  if (!PyArg_ParseTuple(args, "OOO", &cap, &fds_obj, &cl_obj))
    return NULL;
  zk_uring *u = uring_from_capsule(cap);
  if (!u) return NULL;
  PyObject *fast = PySequence_Fast(fds_obj, "fds must be a sequence");
  if (!fast) return NULL;
  PyObject *clfast =
      PySequence_Fast(cl_obj, "chunklists must be a sequence");
  if (!clfast) {
    Py_DECREF(fast);
    return NULL;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  if (PySequence_Fast_GET_SIZE(clfast) != n) {
    PyErr_SetString(PyExc_ValueError, "fds/chunklists length mismatch");
    Py_DECREF(fast);
    Py_DECREF(clfast);
    return NULL;
  }
  PyObject *results = PyList_New(n);
  if (!results) {
    Py_DECREF(fast);
    Py_DECREF(clfast);
    return NULL;
  }
  long enters = 0;
  Py_ssize_t done = 0;
  while (done < n) {
    Py_ssize_t wave = n - done;
    if (wave > (Py_ssize_t)u->sq_entries) wave = u->sq_entries;
    /* per-wave scratch: msghdr + acquired chunk buffers per entry */
    struct msghdr *msgs = PyMem_Calloc(wave, sizeof(struct msghdr));
    Py_buffer **bufsv = PyMem_Calloc(wave, sizeof(Py_buffer *));
    struct iovec **iovv = PyMem_Calloc(wave, sizeof(struct iovec *));
    PyObject **fastv = PyMem_Calloc(wave, sizeof(PyObject *));
    Py_ssize_t *nchv = PyMem_Calloc(wave, sizeof(Py_ssize_t));
    char *filled = PyMem_Calloc(wave, 1);
    if (!msgs || !bufsv || !iovv || !fastv || !nchv || !filled) {
      PyMem_Free(msgs);
      PyMem_Free(bufsv);
      PyMem_Free(iovv);
      PyMem_Free(fastv);
      PyMem_Free(nchv);
      PyMem_Free(filled);
      Py_DECREF(fast);
      Py_DECREF(clfast);
      Py_DECREF(results);
      return PyErr_NoMemory();
    }
    int bad = 0;
    int inflight = 0; /* wait-phase enter failure: submitted sends may
                       * still run — the kernel reads their iovecs and
                       * buffers, so the unreaped entries' resources
                       * must be LEAKED, never released */
    u->gen++;
    unsigned tail = *u->sq_tail;
    for (Py_ssize_t k = 0; k < wave; k++) {
      int fd;
      PyObject *chunks;
      if (batch_entry(fast, clfast, done + k, &fd, &chunks) < 0) {
        bad = 1;
        break;
      }
      nchv[k] = acquire_iov(chunks, &bufsv[k], &iovv[k], &fastv[k]);
      if (nchv[k] < 0) {
        bad = 1;
        break;
      }
      msgs[k].msg_iov = iovv[k];
      msgs[k].msg_iovlen = (size_t)nchv[k];
      unsigned slot = tail & *u->sq_mask;
      struct zk_sqe *sqe = &u->sqes[slot];
      memset(sqe, 0, sizeof(*sqe));
      sqe->opcode = ZK_IORING_OP_SENDMSG;
      sqe->fd = fd;
      sqe->addr = (uint64_t)(uintptr_t)&msgs[k];
      sqe->len = 1;
      sqe->msg_flags = MSG_DONTWAIT | MSG_NOSIGNAL;
      sqe->user_data = (u->gen << 20) | (uint64_t)k;
      u->sq_array[slot] = slot;
      tail++;
    }
    if (!bad) {
      __atomic_store_n(u->sq_tail, tail, __ATOMIC_RELEASE);
      /* ONE syscall: submit the whole wave and wait for all of its
       * completions (MSG_DONTWAIT makes every send complete inline,
       * -EAGAIN instead of punting to a poll wait) */
      Py_ssize_t reaped = 0;
      unsigned to_submit = (unsigned)wave;
      int failed_errno = 0;
      while (reaped < wave) {
        int submit_phase = to_submit != 0;
        long r;
        do {
          r = syscall(__NR_io_uring_enter, u->ring_fd, to_submit,
                      (unsigned)(wave - reaped),
                      ZK_IORING_ENTER_GETEVENTS, NULL, 0);
        } while (r < 0 && errno == EINTR);
        enters++;
        if (r < 0) {
          /* a failed SUBMIT enter consumed no SQEs — the caller may
           * safely resend those entries elsewhere; a failed WAIT
           * enter leaves already-submitted sends in flight, so the
           * unfilled slots report EIO ("state unknown": resending
           * could duplicate bytes, the caller must drop) */
          failed_errno = submit_phase ? errno : EIO;
          if (!submit_phase) inflight = 1;
        }
        to_submit = 0;
        /* reap whatever is available — after an enter failure this is
         * the best-effort pass that keeps real completions (and
         * drains them so they cannot leak into the next wave) */
        unsigned head = __atomic_load_n(u->cq_head, __ATOMIC_ACQUIRE);
        unsigned ctail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
        while (head != ctail) {
          struct zk_cqe *cqe = &u->cqarr[head & *u->cq_mask];
          head++;
          if ((cqe->user_data >> 20) != u->gen)
            continue; /* stale generation: consume and ignore */
          Py_ssize_t k = (Py_ssize_t)(cqe->user_data & 0xFFFFF);
          if (k >= 0 && k < wave && !filled[k]) {
            PyObject *val = PyLong_FromLongLong((long long)cqe->res);
            if (val) PyList_SET_ITEM(results, done + k, val);
            filled[k] = 1;
            reaped++;
          }
        }
        __atomic_store_n(u->cq_head, head, __ATOMIC_RELEASE);
        if (failed_errno) {
          /* entries the failed enter never submitted (or whose
           * completions did not arrive) report the errno; slots a
           * real CQE already filled keep their true result */
          long long e = -(long long)failed_errno;
          for (Py_ssize_t k = 0; k < wave; k++) {
            if (filled[k]) continue;
            PyObject *val = PyLong_FromLongLong(e);
            if (val) PyList_SET_ITEM(results, done + k, val);
            filled[k] = 2; /* errno-filled: possibly still in flight */
          }
          break;
        }
      }
    }
    for (Py_ssize_t k = 0; k < wave; k++)
      /* an inflight wave's unreaped entries stay kernel-readable:
       * leak their buffer views (and msgs below) rather than hand
       * the kernel freed memory to send from */
      if (fastv[k] && !(inflight && filled[k] == 2))
        release_iov(bufsv[k], iovv[k], fastv[k], nchv[k]);
    if (!inflight) PyMem_Free(msgs);
    PyMem_Free(bufsv);
    PyMem_Free(iovv);
    PyMem_Free(fastv);
    PyMem_Free(nchv);
    PyMem_Free(filled);
    if (bad) {
      Py_DECREF(fast);
      Py_DECREF(clfast);
      Py_DECREF(results);
      return NULL;
    }
    done += wave;
  }
  Py_DECREF(fast);
  Py_DECREF(clfast);
  return Py_BuildValue("(Nl)", results, enters);
}

/* Batched receive through the ring (io/ingress.py uring arm): one
 * RECVMSG SQE per dirty connection, ONE enter submits and reaps the
 * wave — O(1) syscalls per drain regardless of the dirty-set width.
 * RECVMSG is the stable v5.1 ABI like the send side's SENDMSG; the
 * multishot upgrade (IORING_RECV_MULTISHOT, >= 5.19/6.0 kernels:
 * one standing SQE per connection, completions without resubmission)
 * is declared below and carried until a kernel that has it can
 * measure it — this image's 4.4 kernel gates the whole arm off at
 * probe time anyway. */

#define ZK_IORING_OP_RECVMSG 10
#define ZK_IORING_RECV_MULTISHOT (1u << 1) /* sqe->ioprio flag */

static PyObject *py_uring_recv(PyObject *self, PyObject *args) {
  PyObject *cap, *fds_obj;
  int bufsize;
  if (!PyArg_ParseTuple(args, "OOi", &cap, &fds_obj, &bufsize))
    return NULL;
  if (bufsize <= 0) {
    PyErr_SetString(PyExc_ValueError, "bufsize must be positive");
    return NULL;
  }
  zk_uring *u = uring_from_capsule(cap);
  if (!u) return NULL;
  PyObject *fast = PySequence_Fast(fds_obj, "fds must be a sequence");
  if (!fast) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject *results = PyList_New(n);
  if (!results) {
    Py_DECREF(fast);
    return NULL;
  }
  long enters = 0;
  Py_ssize_t done = 0;
  while (done < n) {
    Py_ssize_t wave = n - done;
    if (wave > (Py_ssize_t)u->sq_entries) wave = u->sq_entries;
    struct msghdr *msgs = PyMem_Calloc(wave, sizeof(struct msghdr));
    struct iovec *iov = PyMem_Calloc(wave, sizeof(struct iovec));
    PyObject **bufv = PyMem_Calloc(wave, sizeof(PyObject *));
    char *filled = PyMem_Calloc(wave, 1);
    if (!msgs || !iov || !bufv || !filled) {
      PyMem_Free(msgs);
      PyMem_Free(iov);
      PyMem_Free(bufv);
      PyMem_Free(filled);
      Py_DECREF(fast);
      Py_DECREF(results);
      return PyErr_NoMemory();
    }
    int bad = 0;
    int inflight = 0; /* wait-phase enter failure: submitted recvs may
                       * still complete — their buffers (and the
                       * msghdr/iovec the SQEs point at) belong to the
                       * kernel now and must be LEAKED, never freed,
                       * or a late completion DMA-writes freed heap */
    u->gen++;
    unsigned tail = *u->sq_tail;
    for (Py_ssize_t k = 0; k < wave; k++) {
      long fd = PyLong_AsLong(PySequence_Fast_GET_ITEM(fast, done + k));
      if (fd == -1 && PyErr_Occurred()) {
        bad = 1;
        break;
      }
      bufv[k] = PyBytes_FromStringAndSize(NULL, bufsize);
      if (!bufv[k]) {
        bad = 1;
        break;
      }
      iov[k].iov_base = PyBytes_AS_STRING(bufv[k]);
      iov[k].iov_len = (size_t)bufsize;
      msgs[k].msg_iov = &iov[k];
      msgs[k].msg_iovlen = 1;
      unsigned slot = tail & *u->sq_mask;
      struct zk_sqe *sqe = &u->sqes[slot];
      memset(sqe, 0, sizeof(*sqe));
      sqe->opcode = ZK_IORING_OP_RECVMSG;
      sqe->fd = (int)fd;
      sqe->addr = (uint64_t)(uintptr_t)&msgs[k];
      sqe->len = 1;
      sqe->msg_flags = MSG_DONTWAIT;
      sqe->user_data = (u->gen << 20) | (uint64_t)k;
      u->sq_array[slot] = slot;
      tail++;
    }
    if (!bad) {
      __atomic_store_n(u->sq_tail, tail, __ATOMIC_RELEASE);
      Py_ssize_t reaped = 0;
      unsigned to_submit = (unsigned)wave;
      int failed_errno = 0;
      while (reaped < wave) {
        int submit_phase = to_submit != 0;
        long r;
        do {
          r = syscall(__NR_io_uring_enter, u->ring_fd, to_submit,
                      (unsigned)(wave - reaped),
                      ZK_IORING_ENTER_GETEVENTS, NULL, 0);
        } while (r < 0 && errno == EINTR);
        enters++;
        if (r < 0) {
          /* same contract as uring_submit: a failed SUBMIT enter
           * consumed no SQEs (the caller may retry elsewhere); a
           * failed WAIT enter leaves recvs possibly in flight, so
           * unfilled slots report EIO — their buffers were handed to
           * the kernel and must not be reused */
          failed_errno = submit_phase ? errno : EIO;
          if (!submit_phase) inflight = 1;
        }
        to_submit = 0;
        unsigned head = __atomic_load_n(u->cq_head, __ATOMIC_ACQUIRE);
        unsigned ctail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
        while (head != ctail) {
          struct zk_cqe *cqe = &u->cqarr[head & *u->cq_mask];
          head++;
          if ((cqe->user_data >> 20) != u->gen)
            continue; /* stale generation: consume and ignore */
          Py_ssize_t k = (Py_ssize_t)(cqe->user_data & 0xFFFFF);
          if (k >= 0 && k < wave && !filled[k]) {
            PyObject *val;
            if (cqe->res < 0) {
              val = PyLong_FromLong((long)cqe->res);
              Py_CLEAR(bufv[k]);
            } else {
              val = bufv[k];
              bufv[k] = NULL;
              if (cqe->res < bufsize &&
                  _PyBytes_Resize(&val, cqe->res) < 0) {
                PyErr_Clear();
                val = PyLong_FromLong(-(long)ENOMEM);
              }
            }
            if (val) PyList_SET_ITEM(results, done + k, val);
            filled[k] = 1;
            reaped++;
          }
        }
        __atomic_store_n(u->cq_head, head, __ATOMIC_RELEASE);
        if (failed_errno) {
          long e = -(long)failed_errno;
          for (Py_ssize_t k = 0; k < wave; k++) {
            if (filled[k]) continue;
            PyObject *val = PyLong_FromLong(e);
            if (val) PyList_SET_ITEM(results, done + k, val);
            filled[k] = 1;
          }
          break;
        }
      }
    }
    if (!inflight) {
      /* normal wave: every CQE reaped (or nothing was submitted) —
       * slots still in bufv are ours to drop */
      for (Py_ssize_t k = 0; k < wave; k++) Py_XDECREF(bufv[k]);
      PyMem_Free(msgs);
      PyMem_Free(iov);
    }
    /* inflight: leak bufv[k] objects + msgs/iov (kernel-owned); the
     * bookkeeping arrays below were never handed to the kernel */
    PyMem_Free(bufv);
    PyMem_Free(filled);
    if (bad) {
      Py_DECREF(fast);
      Py_DECREF(results);
      return NULL;
    }
    done += wave;
  }
  Py_DECREF(fast);
  return Py_BuildValue("(Nl)", results, enters);
}

static PyObject *py_uring_close(PyObject *self, PyObject *args) {
  PyObject *cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return NULL;
  zk_uring *u = (zk_uring *)PyCapsule_GetPointer(cap, "zkwire.uring");
  if (!u) return NULL;
  if (u != &uring_closed) {
    /* point the capsule at the sentinel first so the destructor (or
     * a second close) can never double-free */
    if (PyCapsule_SetPointer(cap, &uring_closed) < 0) return NULL;
    uring_free(u);
  }
  Py_RETURN_NONE;
}

#else /* !__linux__ */

static PyObject *py_uring_unsupported(PyObject *self, PyObject *args) {
  errno = ENOSYS;
  return PyErr_SetFromErrno(PyExc_OSError);
}
#define py_uring_create py_uring_unsupported
#define py_uring_submit py_uring_unsupported
#define py_uring_recv py_uring_unsupported
#define py_uring_close py_uring_unsupported

#endif /* __linux__ */

static PyMethodDef methods[] = {
    {"setup", py_setup, METH_VARARGS,
     "setup(Stat, ACL, Id, Perm, CreateFlag, err_names, notif_types, "
     "states, layouts, req_opcodes, op_names, err_codes, notif_codes, "
     "state_codes, op_codes) — see native.ext_setup_args() for the "
     "canonical argument builder"},
    {"decode_responses", py_decode_responses, METH_VARARGS,
     "decode_responses(buf, xid_map, max_packet) -> "
     "(pkts, consumed, err_kind, err_msg)"},
    {"decode_requests", py_decode_requests, METH_VARARGS,
     "decode_requests(buf, max_packet) -> "
     "(pkts, consumed, err_kind, err_msg)"},
    {"encode_request", py_encode_request, METH_VARARGS,
     "encode_request(pkt) -> framed bytes, or None to fall back"},
    {"encode_response", py_encode_response, METH_VARARGS,
     "encode_response(pkt) -> framed bytes, or None to fall back"},
    {"crc32c", py_crc32c, METH_VARARGS,
     "crc32c(data, crc=0) -> CRC32C (Castagnoli) of data, chainable"},
    {"submit_writev", py_submit_writev, METH_VARARGS,
     "submit_writev(fds, chunklists) -> [written|-errno, ...] — one "
     "vectored write per entry, join-free (parallel arrays)"},
    {"uring_create", py_uring_create, METH_VARARGS,
     "uring_create(depth=256) -> capsule (OSError when io_uring is "
     "unavailable)"},
    {"uring_submit", py_uring_submit, METH_VARARGS,
     "uring_submit(ring, fds, chunklists) -> "
     "([sent|-errno, ...], enter_syscalls) — one chained submission "
     "covering the whole batch"},
    {"drain_recv", py_drain_recv, METH_VARARGS,
     "drain_recv(fds, bufsize) -> [bytes|-errno, ...] — one receive "
     "per fd in ONE C call (b'' = EOF; -EAGAIN = nothing pending)"},
    {"uring_recv", py_uring_recv, METH_VARARGS,
     "uring_recv(ring, fds, bufsize) -> "
     "([bytes|-errno, ...], enter_syscalls) — one chained RECVMSG "
     "submission covering the whole dirty set"},
    {"uring_close", py_uring_close, METH_VARARGS,
     "uring_close(ring) — unmap and close the ring fd"},
    {"abi_version", py_abi_version, METH_NOARGS, "native ABI version"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_zkwire_ext_torch",
    "C codec for the zkstream_tpu_torch receive hot path", -1, methods};

PyMODINIT_FUNC PyInit__zkwire_ext_torch(void) {
  crc32c_table_init();
  s_xid = PyUnicode_InternFromString("xid");
  s_zxid = PyUnicode_InternFromString("zxid");
  s_err = PyUnicode_InternFromString("err");
  s_opcode = PyUnicode_InternFromString("opcode");
  s_data = PyUnicode_InternFromString("data");
  s_stat = PyUnicode_InternFromString("stat");
  s_path = PyUnicode_InternFromString("path");
  s_children = PyUnicode_InternFromString("children");
  s_acl = PyUnicode_InternFromString("acl");
  s_type = PyUnicode_InternFromString("type");
  s_state = PyUnicode_InternFromString("state");
  s_watch = PyUnicode_InternFromString("watch");
  s_version = PyUnicode_InternFromString("version");
  s_relZxid = PyUnicode_InternFromString("relZxid");
  s_events = PyUnicode_InternFromString("events");
  s_flags = PyUnicode_InternFromString("flags");
  s_mode = PyUnicode_InternFromString("mode");
  s_notification = PyUnicode_InternFromString("NOTIFICATION");
  s_ping = PyUnicode_InternFromString("PING");
  s_auth = PyUnicode_InternFromString("AUTH");
  s_set_watches = PyUnicode_InternFromString("SET_WATCHES");
  s_ok = PyUnicode_InternFromString("OK");
  s_dataChanged = PyUnicode_InternFromString("dataChanged");
  s_createdOrDestroyed =
      PyUnicode_InternFromString("createdOrDestroyed");
  s_childrenChanged = PyUnicode_InternFromString("childrenChanged");
  s_persistent = PyUnicode_InternFromString("persistent");
  s_persistentRecursive =
      PyUnicode_InternFromString("persistentRecursive");
  s_results = PyUnicode_InternFromString("results");
  s_op = PyUnicode_InternFromString("op");
  s_ops = PyUnicode_InternFromString("ops");
  s_op_create = PyUnicode_InternFromString("create");
  s_op_delete = PyUnicode_InternFromString("delete");
  s_op_set_data = PyUnicode_InternFromString("set_data");
  s_op_check = PyUnicode_InternFromString("check");
  s_op_error = PyUnicode_InternFromString("error");
  s_perms = PyUnicode_InternFromString("perms");
  s_scheme = PyUnicode_InternFromString("scheme");
  s_id_attr = PyUnicode_InternFromString("id");
  return PyModule_Create(&moduledef);
}
