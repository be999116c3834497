/* _zkwire_ext_torch: CPython-extension codec for the per-connection
 * receive hot path of zkstream_tpu_torch (the PyTorch/CUDA port).
 *
 * This is the port's own copy of the codec half of native/zkwire_ext.c
 * (the JAX package's extension): setup, the reply and request decoders,
 * the encoders and abi_version.  The transport half (crc32c,
 * submit_writev, drain_recv, the io_uring calls) is not here: nothing
 * in the port uses it yet.  The module has a name and an ABI number of
 * its own, so both extensions can live in one process, each with its
 * own statics (the record classes and name tables setup() registers)
 * set up from its own package.
 *
 * Why it exists: the pure-Python scalar decode spends most of its time
 * in jute primitive reads — per-field struct.unpack_from calls, bounds
 * checks, and dict/dataclass plumbing in protocol/{jute,records}.py.
 * Framing alone is cheap (the plain-C-ABI scanner in zkwire.cpp covers
 * it), so the profitable native boundary is the *whole* receive
 * transform: accumulated bytes -> list of packet dicts, in one C pass.
 * That is the same span the reference executes per socket read (frame
 * loop lib/zk-streams.js:39-99 + reply parse lib/zk-buffer.js:275-370).
 * FleetIngest (io/ingest.py) hands it each stream's frame-complete
 * slice after the device scan in body_mode='host'.
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

#include <stdint.h>
#include <string.h>

/* the loader (utils/native.py _EXT_ABI_VERSION) rejects any other */
#define ZKWIRE_EXT_TORCH_ABI 1

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

static PyMethodDef methods[] = {
    {"setup", py_setup, METH_VARARGS,
     "setup(Stat, ACL, Id, Perm, CreateFlag, err_names, notif_types, "
     "states, layouts, req_opcodes, op_names, err_codes, notif_codes, "
     "state_codes, op_codes) — see native.ext_setup_args() for the "
     "canonical argument tuple"},
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
    {"abi_version", py_abi_version, METH_NOARGS, "native ABI version"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_zkwire_ext_torch",
    "C codec for the zkstream_tpu_torch receive hot path", -1, methods};

PyMODINIT_FUNC PyInit__zkwire_ext_torch(void) {
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
