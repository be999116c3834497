/* zkloadgen — raw-socket C load generator for the zkstream wire
 * protocol (zkstream_tpu_torch/csrc/loadgen.c; README "Load
 * generation").  This is the port's own copy of the JAX package's
 * tools/loadgen.c: the wire format, the exit codes, the summary JSON
 * and the --stdio-sync READY/GO protocol are the same byte for byte.
 * It departs from that file in one place, the phase handshake in
 * thread_main: a thread that has finished a phase keeps its
 * phase_done stamp until g_phase moves on (see the comment there).
 *
 * A Python client pump caps what a bench can drive long before a
 * server does, so a server-side ceiling measured with Python workers
 * is the client's.  This program is the measuring instrument that
 * removes the instrument from the measurement: it
 * drives the real wire protocol (handshake, ping, get/exists/list,
 * create/set, watch arm, SET_WATCHES) at hardware speed while doing
 * ONLY what correctness requires per reply in C:
 *
 *   - frame split + 16-byte header decode (xid / zxid / err);
 *   - per-session **zxid floor checking** — a reply carrying a zxid
 *     below what this session has already seen is a session-
 *     consistency violation (the claim the read plane makes must
 *     survive the speed; exit code 4);
 *   - in-order xid matching against a per-connection outstanding
 *     ring (ZK replies are FIFO per connection; special xids -1/-2/-8
 *     route to notification/ping/SET_WATCHES accounting);
 *   - latency via reservoir sampling per op class (bounded memory at
 *     any op count);
 *   - malformed / torn replies (bad length prefix, short header, EOF
 *     mid-frame, xid matching nothing) are DISTINCT failures (exit
 *     code 3), never silently skipped bytes.
 *
 * Syscall discipline: requests are stamped from canned single-pass
 * encode templates (patch xid / path-suffix bytes, no per-op
 * serialization walk) and coalesced into one write(2) per drain;
 * replies are pulled in 256 KiB read(2) calls, so deep pipelines
 * amortize both directions to a small fraction of a syscall per op.
 * TCP gives each session its own byte stream, so sendmmsg/recvmmsg
 * (one syscall, many DATAGRAMS on one fd) buys nothing here — the
 * equivalent batching lever for streams is exactly this coalescing,
 * and the capability probing this build inherits from zkwire_ext is
 * spent where it pays: IP_BIND_ADDRESS_NO_PORT for the million-
 * socket source-port spread, RLIMIT_NOFILE raising with the binding
 * constraint named in the summary when the host cap wins.
 *
 * Phases (any subset, driven by flags):
 *   connect ramp (--ramp hs/s: handshake storms are a WORKLOAD, not
 *   an accident) -> optional stdio sync (READY/GO, the read_worker
 *   protocol) -> optional watch arm -> steady window (--mix op
 *   weights | --count parity mode | --idle-ping keepalive-only) ->
 *   optional fan-out rounds (one writer, every session a watcher) ->
 *   optional SET_WATCHES re-arm storm (the post-failover shape) ->
 *   drain -> one JSON summary line on stdout (the bench's cell
 *   schema, zkstream_tpu_torch/bench.py).
 *
 * Built by zkstream_tpu_torch/utils/native.py (build_loadgen) into
 * build/ with the same graceful skip-when-no-compiler discipline as
 * the C-extension codec; the Python read workers stay as the
 * env-gated validator arm (ZKSTREAM_LOADGEN=py), cross-checked for
 * op-count / zxid parity in tests/test_torch_loadgen.py.
 */

#define _GNU_SOURCE
#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <inttypes.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <signal.h>
#include <stdarg.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/resource.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#ifndef IP_BIND_ADDRESS_NO_PORT
#define IP_BIND_ADDRESS_NO_PORT 24   /* linux/in.h, kernel >= 4.2 */
#endif

/* ---- wire constants (protocol/consts.py) ---- */
#define OP_CREATE 1
#define OP_EXISTS 3
#define OP_GET_DATA 4
#define OP_SET_DATA 5
#define OP_GET_CHILDREN 8
#define OP_PING 11
#define OP_SET_WATCHES 101
#define OP_ADD_WATCH 106
#define OP_CLOSE_SESSION (-11)

#define XID_NOTIFICATION (-1)
#define XID_PING (-2)
#define XID_SET_WATCHES (-8)

#define MAX_FRAME (16 * 1024 * 1024)
#define RXCHUNK (256 * 1024)

/* ---- op classes for accounting ---- */
enum {
    CLS_GET = 0, CLS_EXISTS, CLS_LIST, CLS_CREATE, CLS_SET,
    CLS_PING, CLS_ARM, CLS_SETW, CLS_ADDW, CLS_CLOSE, CLS_N
};
static const char *CLS_NAME[CLS_N] = {
    "GET_DATA", "EXISTS", "GET_CHILDREN", "CREATE", "SET_DATA",
    "PING", "WATCH_ARM", "SET_WATCHES", "ADD_WATCH", "CLOSE_SESSION"
};

/* ---- exit codes (tests/test_torch_loadgen.py relies on these) ---- */
#define EXIT_OK 0
#define EXIT_USAGE 2
#define EXIT_PROTO 3       /* malformed / torn / unmatched reply */
#define EXIT_ZXID_FLOOR 4  /* session-consistency violation */
#define EXIT_CONNECT 5     /* nothing connected at all */

/* ---- phases ---- */
enum {
    PH_CONNECT = 0, PH_HOLD, PH_ARM, PH_STEADY, PH_FANOUT,
    PH_SETWATCHES, PH_DRAIN, PH_DONE
};

/* ---- reservoir ---- */
#define RES_N 4096
typedef struct {
    double v[RES_N];
    uint64_t n;
} res_t;

static void res_add(res_t *r, uint64_t *rng, double x) {
    uint64_t i = r->n++;
    if (i < RES_N) { r->v[i] = x; return; }
    /* xorshift64* */
    uint64_t s = *rng;
    s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
    *rng = s;
    uint64_t j = (s * 2685821657736338717ULL) % r->n;
    if (j < RES_N) r->v[j] = x;
}

static int cmp_dbl(const void *a, const void *b) {
    double x = *(const double *)a, y = *(const double *)b;
    return (x > y) - (x < y);
}

static double res_pct(res_t *r, double p) {
    uint64_t n = r->n < RES_N ? r->n : RES_N;
    if (!n) return 0.0;
    /* sorted in place by the reporting pass only */
    uint64_t k = (uint64_t)(p / 100.0 * (double)(n - 1));
    return r->v[k];
}

static void res_sort(res_t *r) {
    uint64_t n = r->n < RES_N ? r->n : RES_N;
    qsort(r->v, n, sizeof(double), cmp_dbl);
}

/* ---- config ---- */
typedef struct {
    struct sockaddr_in servers[64];
    int n_servers;
    int sessions;
    int threads;
    double duration_s;       /* steady window; <=0 with count==0: skip */
    int pipeline;
    int count_per_session;   /* parity mode: exact ops per session */
    double ramp;             /* handshakes/s, 0 = unpaced */
    double idle_ping_s;      /* >0: keepalive-only steady phase */
    int weights[CLS_N];      /* steady op mix */
    int arm_watch;           /* arm a data watch per session pre-window */
    int fanout_sets;         /* fan-out rounds (writer: session 0) */
    double watch_wait_s;
    int setwatches_storm;    /* post-window SET_WATCHES re-arm storm */
    int data_len;
    char path[128];          /* hot path for get/set/watch */
    int ensure_path;         /* CREATE the hot path first */
    int session_timeout_ms;
    double connect_timeout_s;
    int stdio_sync;          /* READY/GO protocol with the bench */
    int src_addrs;           /* 127.0.0.x spread (0 = auto) */
    int close_sessions;      /* CLOSE_SESSION before closing sockets */
    double drain_s;
    int quiet;
    int cached;              /* ADD_WATCH(recursive) arm + local cache sim */
    double cached_write_s;   /* writer churn interval during CACHED steady */
} cfg_t;

/* ---- per-connection state ---- */
typedef struct {
    int32_t xid;
    uint8_t cls;
    int64_t t_ns;
} slot_t;

typedef struct conn {
    int fd;
    uint8_t state;       /* 0 closed, 1 connecting, 2 hs sent, 3 ready */
    uint8_t armed;       /* data watch currently armed */
    uint8_t cache_valid; /* cached mode: local entry serves without wire */
    uint8_t refill_inflight; /* cached mode: one wire refill at a time */
    uint8_t in_epoll_out;
    int32_t next_xid;
    int64_t session_id;
    int64_t zxid_floor;
    uint32_t q_head, q_len;          /* outstanding ring */
    slot_t *q;
    uint8_t *rbuf; uint32_t rlen, rcap;
    uint8_t *wbuf; uint32_t wlen, woff, wcap;
    int64_t t_connect_ns, t_ready_ns;
    int64_t t_ping_ns, t_setw_ns, t_last_tx_ns;
    int64_t t_invalidated_ns;        /* cached mode: notification arrival */
    int32_t quota_left;              /* count mode */
    int32_t fanout_round_seen;
} conn_t;

#define ST_CLOSED 0
#define ST_CONNECTING 1
#define ST_HANDSHAKE 2
#define ST_READY 3

/* ---- per-thread state ---- */
typedef struct {
    pthread_t tid;
    int idx;
    int epfd;
    conn_t *conns;
    uint8_t *scratch;    /* one RXCHUNK read buffer per THREAD, so a
                          * million idle conns don't each pin 256 KiB */
    int n_conns;
    int n_live, n_ready, n_failed;
    uint64_t rng;
    /* canned templates */
    uint8_t tpl[CLS_N][512];
    uint32_t tpl_len[CLS_N];
    uint32_t tpl_xid_off[CLS_N];
    uint32_t tpl_create_suffix_off;
    uint64_t create_seq;
    /* accounting */
    uint64_t ops[CLS_N], ops_win[CLS_N], errs_srv[CLS_N];
    uint64_t notifications, notif_win;
    uint64_t proto_errs, floor_violations, connect_errs, io_errs;
    uint64_t bytes_rx, bytes_tx, tx_syscalls, rx_syscalls;
    int64_t max_zxid, acked_write_zxid;
    uint64_t cache_hits, cache_hits_win, cache_invalidations;
    int64_t t_last_cset_ns;          /* cached mode: last writer churn */
    res_t lat[CLS_N];      /* reply latency, microseconds */
    res_t hs;              /* handshake latency */
    res_t cache_hit_lat;   /* local cached-read latency, microseconds */
    res_t cache_refill_lat;/* invalidation -> refilled entry, microseconds */
    int64_t first_ready_ns, last_ready_ns;
    int phase_done;        /* this thread finished current phase */
    /* steady refill round-robin cursor + ping sweep cursor */
    int rr, ping_cursor;
} thr_t;

/* ---- globals ---- */
static cfg_t C;
static thr_t *T;
static volatile sig_atomic_t g_stop = 0;
static _Atomic int g_phase = PH_CONNECT;
static int64_t g_t0_ns;                   /* program start */
static _Atomic long g_window_end_ms = 0;  /* steady window end (rel ms) */
static _Atomic long g_window_start_ms = 0;
static _Atomic unsigned long g_fanout_notifs = 0;
static _Atomic int g_fanout_round = -1;
static _Atomic int g_fanout_fire = 0;   /* main asks thread 0 to SET */
static _Atomic int g_fanout_done = 0;
/* currently-armed watch GAUGE (not a cumulative ack count): raised
 * on ARM/SET_WATCHES acks, dropped when a notification consumes the
 * one-shot watch — run_fanout's per-round expectation reads it */
static _Atomic long g_armed_now = 0;
/* fan-out per-round timing (writer thread only writes these) */
static double g_fanout_round_ms[4096];
static int g_fanout_rounds_run = 0;
static uint64_t g_fanout_expected = 0, g_fanout_delivered = 0;
/* rlimit / caps report */
static long g_nofile_soft0, g_nofile_soft, g_nofile_hard;
static int g_sessions_clamped = 0;
static char g_binding_constraint[256] = "";
static int g_bind_no_port_ok = -1;
static double g_setw_storm_s = 0.0;

static int64_t now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static void die(const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vfprintf(stderr, fmt, ap);
    fputc('\n', stderr);
    va_end(ap);
    exit(EXIT_USAGE);
}

static void on_sigint(int sig) { (void)sig; g_stop = 1; }

/* ---- big-endian stores ---- */
static void be32(uint8_t *p, int32_t v) {
    uint32_t u = (uint32_t)v;
    p[0] = u >> 24; p[1] = u >> 16; p[2] = u >> 8; p[3] = u;
}
static void be64(uint8_t *p, int64_t v) {
    uint64_t u = (uint64_t)v;
    for (int i = 7; i >= 0; i--) { p[i] = u & 0xff; u >>= 8; }
}
static int32_t rd32(const uint8_t *p) {
    return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
                     | ((uint32_t)p[2] << 8) | p[3]);
}
static int64_t rd64(const uint8_t *p) {
    uint64_t u = 0;
    for (int i = 0; i < 8; i++) u = (u << 8) | p[i];
    return (int64_t)u;
}

/* ---- canned single-pass encode templates ----
 * Each op class gets one pre-serialized frame; stamping a request is
 * a memcpy + a 4-byte xid patch (+ a hex suffix patch for CREATE's
 * unique path), never a field-by-field serialization walk. */
static uint32_t tpl_begin(uint8_t *t, int32_t opcode) {
    be32(t + 4, 0);             /* xid patched per send */
    be32(t + 8, opcode);
    return 12;
}
static uint32_t tpl_str(uint8_t *t, uint32_t o, const char *s) {
    uint32_t n = (uint32_t)strlen(s);
    be32(t + o, (int32_t)n);
    memcpy(t + o + 4, s, n);
    return o + 4 + n;
}
static uint32_t tpl_finish(uint8_t *t, uint32_t o) {
    be32(t, (int32_t)(o - 4));  /* length prefix */
    return o;
}

static void build_templates(thr_t *th) {
    uint8_t *t; uint32_t o;
    /* GET_DATA path watch=0 */
    t = th->tpl[CLS_GET];
    o = tpl_begin(t, OP_GET_DATA);
    o = tpl_str(t, o, C.path);
    t[o++] = 0;
    th->tpl_len[CLS_GET] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_GET] = 4;
    /* EXISTS path watch=0 */
    t = th->tpl[CLS_EXISTS];
    o = tpl_begin(t, OP_EXISTS);
    o = tpl_str(t, o, C.path);
    t[o++] = 0;
    th->tpl_len[CLS_EXISTS] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_EXISTS] = 4;
    /* GET_CHILDREN path watch=0 */
    t = th->tpl[CLS_LIST];
    o = tpl_begin(t, OP_GET_CHILDREN);
    o = tpl_str(t, o, C.path);
    t[o++] = 0;
    th->tpl_len[CLS_LIST] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_LIST] = 4;
    /* WATCH_ARM = GET_DATA path watch=1 */
    t = th->tpl[CLS_ARM];
    o = tpl_begin(t, OP_GET_DATA);
    o = tpl_str(t, o, C.path);
    t[o++] = 1;
    th->tpl_len[CLS_ARM] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_ARM] = 4;
    /* SET_DATA path data version=-1 */
    t = th->tpl[CLS_SET];
    o = tpl_begin(t, OP_SET_DATA);
    o = tpl_str(t, o, C.path);
    be32(t + o, C.data_len); o += 4;
    memset(t + o, 'x', C.data_len); o += C.data_len;
    be32(t + o, -1); o += 4;
    th->tpl_len[CLS_SET] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_SET] = 4;
    /* CREATE path+suffix data acl=[world:anyone ALL] flags=0; the
     * 16-hex-digit suffix keeps the frame length constant so the
     * template never re-serializes */
    t = th->tpl[CLS_CREATE];
    o = tpl_begin(t, OP_CREATE);
    {
        char pbuf[160];
        snprintf(pbuf, sizeof pbuf, "%s/lg%02x0000000000000000",
                 C.path, th->idx & 0xff);
        uint32_t start = o + 4 + (uint32_t)strlen(C.path) + 5;
        o = tpl_str(t, o, pbuf);
        th->tpl_create_suffix_off = start;
    }
    be32(t + o, C.data_len); o += 4;
    memset(t + o, 'c', C.data_len); o += C.data_len;
    be32(t + o, 1); o += 4;                 /* one ACL */
    be32(t + o, 31); o += 4;                /* Perm.ALL */
    o = tpl_str(t, o, "world");
    o = tpl_str(t, o, "anyone");
    be32(t + o, 0); o += 4;                 /* flags */
    th->tpl_len[CLS_CREATE] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_CREATE] = 4;
    /* PING: header only, reserved xid -2 */
    t = th->tpl[CLS_PING];
    o = tpl_begin(t, OP_PING);
    be32(t + 4, XID_PING);
    th->tpl_len[CLS_PING] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_PING] = 0;          /* fixed xid */
    /* SET_WATCHES: relZxid + [path] dataChanged, [] created, [] child;
     * relZxid patched per send at offset 12 */
    t = th->tpl[CLS_SETW];
    o = tpl_begin(t, OP_SET_WATCHES);
    be32(t + 4, XID_SET_WATCHES);
    be64(t + o, 0); o += 8;                 /* relZxid patch @12 */
    be32(t + o, 1); o += 4;
    o = tpl_str(t, o, C.path);
    be32(t + o, 0); o += 4;
    be32(t + o, 0); o += 4;
    th->tpl_len[CLS_SETW] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_SETW] = 0;
    /* ADD_WATCH path mode=1 (PERSISTENT_RECURSIVE): arms the subtree
     * once; fires survive delivery, so the cached arm never re-arms */
    t = th->tpl[CLS_ADDW];
    o = tpl_begin(t, OP_ADD_WATCH);
    o = tpl_str(t, o, C.path);
    be32(t + o, 1); o += 4;
    th->tpl_len[CLS_ADDW] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_ADDW] = 4;
    /* CLOSE_SESSION: header only */
    t = th->tpl[CLS_CLOSE];
    o = tpl_begin(t, OP_CLOSE_SESSION);
    th->tpl_len[CLS_CLOSE] = tpl_finish(t, o);
    th->tpl_xid_off[CLS_CLOSE] = 4;
}

/* ---- buffered tx ---- */
static void conn_fail(thr_t *th, conn_t *c, int io);

static int wbuf_reserve(conn_t *c, uint32_t need) {
    if (c->wlen + need <= c->wcap) return 0;
    uint32_t cap = c->wcap ? c->wcap : 256;
    while (c->wlen + need > cap) cap *= 2;
    uint8_t *nb = realloc(c->wbuf, cap);
    if (!nb) return -1;
    c->wbuf = nb; c->wcap = cap;
    return 0;
}

static void epoll_want_out(thr_t *th, conn_t *c, int on) {
    if (c->in_epoll_out == on || c->state == ST_CLOSED) return;
    struct epoll_event ev;
    ev.events = EPOLLIN | (on ? EPOLLOUT : 0);
    ev.data.ptr = c;
    if (epoll_ctl(th->epfd, EPOLL_CTL_MOD, c->fd, &ev) == 0)
        c->in_epoll_out = (uint8_t)on;
}

static void conn_flush(thr_t *th, conn_t *c) {
    while (c->woff < c->wlen) {
        ssize_t n = write(c->fd, c->wbuf + c->woff, c->wlen - c->woff);
        if (n > 0) {
            th->tx_syscalls++;
            th->bytes_tx += (uint64_t)n;
            c->woff += (uint32_t)n;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            epoll_want_out(th, c, 1);
            return;
        }
        if (n < 0 && errno == EINTR) continue;
        conn_fail(th, c, 1);
        return;
    }
    c->wlen = c->woff = 0;
    epoll_want_out(th, c, 0);
}

/* Stamp one request from its template into the tx buffer.  Returns 0
 * on success.  Ops with a real xid also claim an outstanding-ring
 * slot; PING/SET_WATCHES ride their reserved xids and per-conn
 * timestamp fields instead (replies to them are not FIFO-matched). */
static int send_op(thr_t *th, conn_t *c, int cls) {
    uint32_t len = th->tpl_len[cls];
    if (wbuf_reserve(c, len)) return -1;
    uint8_t *dst = c->wbuf + c->wlen;
    memcpy(dst, th->tpl[cls], len);
    int64_t t = now_ns();
    if (th->tpl_xid_off[cls]) {
        if (c->q_len >= (uint32_t)C.pipeline) return -1;
        int32_t xid = ++c->next_xid;
        be32(dst + th->tpl_xid_off[cls], xid);
        if (cls == CLS_CREATE) {
            /* unique path: patch the 16-hex-digit suffix in place */
            char hx[17];
            snprintf(hx, sizeof hx, "%016" PRIx64, th->create_seq++);
            memcpy(dst + th->tpl_create_suffix_off, hx, 16);
        }
        slot_t *s = &c->q[(c->q_head + c->q_len) % C.pipeline];
        s->xid = xid; s->cls = (uint8_t)cls; s->t_ns = t;
        c->q_len++;
    } else if (cls == CLS_PING) {
        c->t_ping_ns = t;
    } else if (cls == CLS_SETW) {
        be64(dst + 12, c->zxid_floor);
        c->t_setw_ns = t;
    }
    c->wlen += len;
    c->t_last_tx_ns = t;
    return 0;
}

static void conn_close_fd(thr_t *th, conn_t *c) {
    if (c->state == ST_CLOSED) return;
    epoll_ctl(th->epfd, EPOLL_CTL_DEL, c->fd, NULL);
    close(c->fd);
    c->state = ST_CLOSED;
    th->n_live--;
}

static void conn_fail(thr_t *th, conn_t *c, int io) {
    if (c->state == ST_READY) th->n_ready--;
    if (io) th->io_errs++;
    th->n_failed++;
    conn_close_fd(th, c);
}

/* ---- steady-state op selection ---- */
static int in_window(int64_t t_ns);

/* cached mode: a read served from the valid local entry never touches
 * the wire.  The latency sample is a clock pair around the (trivial)
 * lookup — the honest cost of a hit in this simulation. */
static void cached_hit(thr_t *th) {
    int64_t t0 = now_ns();
    th->cache_hits++;
    if (in_window(t0)) th->cache_hits_win++;
    res_add(&th->cache_hit_lat, &th->rng,
            (double)(now_ns() - t0) / 1000.0);
}

static int is_read_cls(int cls) {
    return cls == CLS_GET || cls == CLS_EXISTS || cls == CLS_LIST;
}

static int pick_cls(thr_t *th) {
    int total = 0;
    for (int i = 0; i < CLS_N; i++) total += C.weights[i];
    uint64_t s = th->rng;
    s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
    th->rng = s;
    int r = (int)((s * 2685821657736338717ULL) % (uint64_t)total);
    for (int i = 0; i < CLS_N; i++) {
        r -= C.weights[i];
        if (r < 0) return i;
    }
    return CLS_GET;
}

static void refill(thr_t *th, conn_t *c) {
    int phase = atomic_load_explicit(&g_phase, memory_order_relaxed);
    if (phase != PH_STEADY || c->state != ST_READY) return;
    if (C.idle_ping_s > 0) return;          /* keepalive-only mode */
    if (C.count_per_session > 0) {
        while (c->quota_left > 0 && c->q_len < (uint32_t)C.pipeline) {
            int cls = pick_cls(th);
            if (C.cached && is_read_cls(cls)) {
                if (c->cache_valid) {
                    cached_hit(th);
                    c->quota_left--;
                    continue;
                }
                /* one wire refill per invalidation, like the client
                 * cache: further reads wait for it */
                if (c->refill_inflight) break;
                if (send_op(th, c, cls)) break;
                c->refill_inflight = 1;
                c->quota_left--;
                continue;
            }
            if (send_op(th, c, cls)) break;
            c->quota_left--;
        }
        return;
    }
    long end_ms = atomic_load_explicit(&g_window_end_ms,
                                       memory_order_relaxed);
    if ((now_ns() - g_t0_ns) / 1000000 >= end_ms) return;
    /* duration mode: cached hits never occupy a ring slot, so cap them
     * per call or a hot cache would spin here and starve the epoll
     * loop that delivers the very invalidations being measured */
    uint32_t hits = 0;
    while (c->q_len < (uint32_t)C.pipeline) {
        int cls = pick_cls(th);
        if (C.cached && is_read_cls(cls)) {
            if (c->cache_valid) {
                cached_hit(th);
                if (++hits >= 8u * (uint32_t)C.pipeline) break;
                continue;
            }
            if (c->refill_inflight) break;
            if (send_op(th, c, cls)) break;
            c->refill_inflight = 1;
            continue;
        }
        if (send_op(th, c, cls)) break;
    }
}

/* ---- reply decode ----
 * One pass over the accumulation buffer: frame split, header decode,
 * floor check, FIFO match, latency, refill.  Returns bytes consumed;
 * -1 flags a protocol error (connection closed, error counted). */
static int in_window(int64_t t_ns) {
    long s = atomic_load_explicit(&g_window_start_ms,
                                  memory_order_relaxed);
    long e = atomic_load_explicit(&g_window_end_ms,
                                  memory_order_relaxed);
    long ms = (long)((t_ns - g_t0_ns) / 1000000);
    return s && ms >= s && ms < e;
}

static void proto_err(thr_t *th, conn_t *c, const char *what) {
    if (!C.quiet)
        fprintf(stderr, "zkloadgen: protocol error (%s) on conn fd=%d\n",
                what, c->fd);
    th->proto_errs++;
    conn_fail(th, c, 0);
}

static void handle_reply(thr_t *th, conn_t *c, const uint8_t *b,
                         uint32_t len, int64_t t) {
    if (c->state == ST_HANDSHAKE) {
        /* ConnectResponse: proto(4) timeOut(4) sessionId(8) passwd */
        if (len < 16) { proto_err(th, c, "short connect response");
                        return; }
        int64_t sid = rd64(b + 8);
        if (sid == 0) {
            th->connect_errs++;
            conn_fail(th, c, 0);
            return;
        }
        c->session_id = sid;
        c->state = ST_READY;
        c->t_ready_ns = t;
        th->n_ready++;
        if (!th->first_ready_ns) th->first_ready_ns = t;
        th->last_ready_ns = t;
        res_add(&th->hs, &th->rng,
                (double)(t - c->t_connect_ns) / 1000.0);
        return;
    }
    if (len < 16) { proto_err(th, c, "short reply header"); return; }
    int32_t xid = rd32(b);
    int64_t zxid = rd64(b + 4);
    int32_t err = rd32(b + 12);
    if (zxid > th->max_zxid) th->max_zxid = zxid;
    if (xid == XID_NOTIFICATION) {
        /* event zxid may legally trail the reply floor (pipelined
         * reads raced ahead of the fan-out): counted, not checked */
        th->notifications++;
        if (in_window(t)) th->notif_win++;
        int round = atomic_load_explicit(&g_fanout_round,
                                         memory_order_relaxed);
        if (round >= 0)
            atomic_fetch_add_explicit(&g_fanout_notifs, 1,
                                      memory_order_relaxed);
        if (C.cached) {
            /* persistent watch: survives the fire, stays armed.  The
             * notification is the invalidation signal — drop the local
             * entry and stamp the arrival so the next GET reply can
             * measure invalidation -> refill latency. */
            if (c->cache_valid) {
                c->cache_valid = 0;
                c->t_invalidated_ns = t;
                th->cache_invalidations++;
            }
            return;
        }
        /* the watch was one-shot: it is GONE now whether this fired
         * from a fan-out round or a steady-window write.  Drop the
         * gauge and re-arm; the ARM ack re-raises it (a full ring
         * loses the re-arm and the gauge stays honest) */
        if (c->armed) {
            c->armed = 0;
            atomic_fetch_sub_explicit(&g_armed_now, 1,
                                      memory_order_relaxed);
        }
        if (C.arm_watch || C.fanout_sets)
            send_op(th, c, CLS_ARM);
        return;
    }
    /* the session-consistency floor: every non-notification reply
     * header carries the serving member's applied zxid, monotone for
     * the life of this connection */
    if (zxid > 0) {
        if (zxid < c->zxid_floor) {
            th->floor_violations++;
            if (!C.quiet && th->floor_violations < 5)
                fprintf(stderr, "zkloadgen: ZXID FLOOR VIOLATION "
                        "session=%016" PRIx64 " reply zxid %" PRId64
                        " < floor %" PRId64 " (xid %d)\n",
                        (uint64_t)c->session_id, zxid,
                        c->zxid_floor, xid);
        } else {
            c->zxid_floor = zxid;
        }
    }
    if (xid == XID_PING) {
        th->ops[CLS_PING]++;
        if (in_window(t)) th->ops_win[CLS_PING]++;
        if (c->t_ping_ns)
            res_add(&th->lat[CLS_PING], &th->rng,
                    (double)(t - c->t_ping_ns) / 1000.0);
        return;
    }
    if (xid == XID_SET_WATCHES) {
        th->ops[CLS_SETW]++;
        if (in_window(t)) th->ops_win[CLS_SETW]++;
        if (err == 0 && !c->armed) {
            c->armed = 1;
            atomic_fetch_add_explicit(&g_armed_now, 1,
                                      memory_order_relaxed);
        }
        if (c->t_setw_ns)
            res_add(&th->lat[CLS_SETW], &th->rng,
                    (double)(t - c->t_setw_ns) / 1000.0);
        return;
    }
    if (c->q_len == 0) { proto_err(th, c, "reply matches no request");
                         return; }
    slot_t *s = &c->q[c->q_head % C.pipeline];
    if (s->xid != xid) { proto_err(th, c, "reply xid out of order");
                         return; }
    c->q_head++; c->q_len--;
    int cls = s->cls;
    th->ops[cls]++;
    if (in_window(t)) th->ops_win[cls]++;
    if (err != 0) {
        th->errs_srv[cls]++;
    } else {
        if (cls == CLS_SET || cls == CLS_CREATE) {
            if (zxid > th->acked_write_zxid)
                th->acked_write_zxid = zxid;
        }
        if ((cls == CLS_ARM || cls == CLS_ADDW) && !c->armed) {
            c->armed = 1;
            atomic_fetch_add_explicit(&g_armed_now, 1,
                                      memory_order_relaxed);
        }
        if (C.cached && cls == CLS_ADDW)
            c->cache_valid = 1;
        if (C.cached && is_read_cls(cls)) {
            /* wire read refills the local entry; if an invalidation
             * was pending, this reply closes the staleness window */
            c->cache_valid = 1;
            if (c->t_invalidated_ns) {
                res_add(&th->cache_refill_lat, &th->rng,
                        (double)(t - c->t_invalidated_ns) / 1000.0);
                c->t_invalidated_ns = 0;
            }
        }
    }
    if (C.cached && is_read_cls(cls))
        c->refill_inflight = 0;
    res_add(&th->lat[cls], &th->rng, (double)(t - s->t_ns) / 1000.0);
    refill(th, c);
}

/* Stash the unparsed tail (a partial frame) in the per-conn residual
 * buffer.  Per-conn memory stays proportional to the largest partial
 * frame ever seen, not to the read chunk size. */
static int rbuf_keep(thr_t *th, conn_t *c, const uint8_t *p,
                     uint32_t len) {
    if (len > c->rcap) {
        uint32_t cap = c->rcap ? c->rcap : 512;
        while (len > cap) cap *= 2;
        uint8_t *nb = realloc(c->rbuf, cap);
        if (!nb) { conn_fail(th, c, 1); return -1; }
        c->rbuf = nb; c->rcap = cap;
    }
    memmove(c->rbuf, p, len);
    c->rlen = len;
    return 0;
}

/* Parse complete frames out of [p, p+len); returns bytes consumed or
 * (uint32_t)-1 if the connection died mid-parse. */
static uint32_t parse_frames(thr_t *th, conn_t *c, const uint8_t *p,
                             uint32_t len, int64_t t) {
    uint32_t off = 0;
    while (len - off >= 4) {
        int32_t ln = rd32(p + off);
        if (ln < 0 || ln > MAX_FRAME) {
            proto_err(th, c, "bad length prefix");
            return (uint32_t)-1;
        }
        if (len - off < 4 + (uint32_t)ln) break;
        handle_reply(th, c, p + off + 4, (uint32_t)ln, t);
        if (c->state == ST_CLOSED) return (uint32_t)-1;
        off += 4 + (uint32_t)ln;
    }
    return off;
}

static void conn_rx(thr_t *th, conn_t *c) {
    for (;;) {
        ssize_t n = read(c->fd, th->scratch, RXCHUNK);
        if (n < 0) {
            if (errno == EAGAIN || errno == EWOULDBLOCK) return;
            if (errno == EINTR) continue;
            conn_fail(th, c, 1);
            return;
        }
        if (n == 0) {
            /* peer closed: bytes left in the residual buffer are a
             * TORN frame — a reply the server started and never
             * finished */
            int draining = atomic_load_explicit(
                &g_phase, memory_order_relaxed) >= PH_DRAIN;
            if (c->rlen > 0 && !draining)
                proto_err(th, c, "torn reply (EOF mid-frame)");
            else if (c->q_len > 0 && !draining)
                conn_fail(th, c, 1);
            else
                conn_close_fd(th, c);
            return;
        }
        th->rx_syscalls++;
        th->bytes_rx += (uint64_t)n;
        int64_t t = now_ns();
        uint32_t used;
        if (c->rlen == 0) {
            /* common case: parse straight out of the shared scratch,
             * zero bytes ever copied into per-conn memory */
            used = parse_frames(th, c, th->scratch, (uint32_t)n, t);
            if (used == (uint32_t)-1) return;
            if (used < (uint32_t)n
                && rbuf_keep(th, c, th->scratch + used,
                             (uint32_t)n - used))
                return;
        } else {
            /* residual partial frame: append, parse the joined run */
            uint32_t need = c->rlen + (uint32_t)n;
            if (need > c->rcap) {
                uint32_t cap = c->rcap ? c->rcap : 512;
                while (need > cap) cap *= 2;
                uint8_t *nb = realloc(c->rbuf, cap);
                if (!nb) { conn_fail(th, c, 1); return; }
                c->rbuf = nb; c->rcap = cap;
            }
            memcpy(c->rbuf + c->rlen, th->scratch, (size_t)n);
            c->rlen = need;
            used = parse_frames(th, c, c->rbuf, c->rlen, t);
            if (used == (uint32_t)-1) return;
            if (used) {
                memmove(c->rbuf, c->rbuf + used, c->rlen - used);
                c->rlen -= used;
            }
        }
        if (n < RXCHUNK) return;   /* socket drained */
    }
}

/* ---- connect path ---- */
static int conn_start(thr_t *th, conn_t *c, int conn_idx) {
    const struct sockaddr_in *sa =
        &C.servers[conn_idx % C.n_servers];
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) { th->connect_errs++; th->n_failed++; return -1; }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    /* million-socket source spread: a single (src ip, dst ip, dst
     * port) triple caps at ~28k ephemeral ports, so connections to a
     * loopback server rotate across 127.0.0.1..127.0.0.K source
     * addresses; IP_BIND_ADDRESS_NO_PORT defers port selection to
     * connect(2) so the kernel can reuse ports across 4-tuples */
    if (C.src_addrs > 1
        && (ntohl(sa->sin_addr.s_addr) >> 24) == 127) {
        struct sockaddr_in src;
        memset(&src, 0, sizeof src);
        src.sin_family = AF_INET;
        src.sin_addr.s_addr =
            htonl(0x7f000001u + (uint32_t)(conn_idx % C.src_addrs));
        if (g_bind_no_port_ok != 0) {
            int r = setsockopt(fd, IPPROTO_IP,
                               IP_BIND_ADDRESS_NO_PORT, &one,
                               sizeof one);
            if (g_bind_no_port_ok < 0)
                g_bind_no_port_ok = (r == 0);
        }
        bind(fd, (struct sockaddr *)&src, sizeof src);
    }
    c->fd = fd;
    c->t_connect_ns = now_ns();
    int r = connect(fd, (const struct sockaddr *)sa, sizeof *sa);
    if (r < 0 && errno != EINPROGRESS) {
        close(fd);
        th->connect_errs++; th->n_failed++;
        return -1;
    }
    c->state = ST_CONNECTING;
    th->n_live++;
    struct epoll_event ev;
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.ptr = c;
    c->in_epoll_out = 1;
    if (epoll_ctl(th->epfd, EPOLL_CTL_ADD, fd, &ev) < 0) {
        close(fd);
        c->state = ST_CLOSED;
        th->n_live--; th->n_failed++; th->connect_errs++;
        return -1;
    }
    return 0;
}

static void conn_send_handshake(thr_t *th, conn_t *c) {
    /* ConnectRequest: proto=0, lastZxidSeen=0, timeOut, sessionId=0,
     * passwd = 16 zero bytes.  48 bytes framed. */
    uint8_t b[48];
    be32(b, 44);
    be32(b + 4, 0);
    be64(b + 8, 0);
    be32(b + 16, C.session_timeout_ms);
    be64(b + 20, 0);
    be32(b + 28, 16);
    memset(b + 32, 0, 16);
    if (wbuf_reserve(c, sizeof b)) { conn_fail(th, c, 1); return; }
    memcpy(c->wbuf + c->wlen, b, sizeof b);
    c->wlen += sizeof b;
    c->state = ST_HANDSHAKE;
    conn_flush(th, c);
}

/* ---- keepalive sweep: amortized O(1) per loop ---- */
static void ping_sweep(thr_t *th, double interval_s) {
    if (interval_s <= 0 || th->n_ready == 0) return;
    int chunk = th->n_conns / 64 + 1;
    int64_t t = now_ns();
    int64_t due = (int64_t)(interval_s * 1e9);
    for (int i = 0; i < chunk; i++) {
        conn_t *c = &th->conns[th->ping_cursor++ % th->n_conns];
        if (c->state != ST_READY) continue;
        if (t - c->t_last_tx_ns >= due) {
            if (!send_op(th, c, CLS_PING)) conn_flush(th, c);
        }
    }
}

/* ---- per-phase thread work ---- */
static void phase_connect(thr_t *th) {
    /* ramp bucket shared across threads: claim a serial, convert to a
     * not-before time */
    static _Atomic long g_hs_serial = 0;
    int64_t deadline = g_t0_ns
        + (int64_t)(C.connect_timeout_s * 1e9);
    int started = 0;
    while (started < th->n_conns && !g_stop) {
        if (C.ramp > 0) {
            long serial = atomic_fetch_add_explicit(
                &g_hs_serial, 1, memory_order_relaxed);
            int64_t not_before = g_t0_ns
                + (int64_t)((double)serial / C.ramp * 1e9);
            while (now_ns() < not_before && !g_stop) {
                struct epoll_event evs[256];
                int n = epoll_wait(th->epfd, evs, 256, 1);
                for (int i = 0; i < n; i++) {
                    conn_t *c = evs[i].data.ptr;
                    if (c->state == ST_CONNECTING
                        && (evs[i].events & (EPOLLOUT | EPOLLERR
                                             | EPOLLHUP))) {
                        int soerr = 0;
                        socklen_t sl = sizeof soerr;
                        getsockopt(c->fd, SOL_SOCKET, SO_ERROR,
                                   &soerr, &sl);
                        if (soerr) { conn_fail(th, c, 1);
                                     th->connect_errs++; continue; }
                        conn_send_handshake(th, c);
                        continue;
                    }
                    if (evs[i].events & EPOLLIN) conn_rx(th, c);
                    if (c->state != ST_CLOSED
                        && (evs[i].events & EPOLLOUT))
                        conn_flush(th, c);
                }
            }
        }
        conn_start(th, &th->conns[started], started * C.threads
                   + th->idx);
        started++;
        /* interleave progress so the backlog never balloons */
        struct epoll_event evs[256];
        int n = epoll_wait(th->epfd, evs, 256, 0);
        for (int i = 0; i < n; i++) {
            conn_t *c = evs[i].data.ptr;
            if (c->state == ST_CONNECTING
                && (evs[i].events & (EPOLLOUT | EPOLLERR | EPOLLHUP))) {
                int soerr = 0;
                socklen_t sl = sizeof soerr;
                getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &soerr, &sl);
                if (soerr) { conn_fail(th, c, 1); th->connect_errs++;
                             continue; }
                conn_send_handshake(th, c);
                continue;
            }
            if (evs[i].events & EPOLLIN) conn_rx(th, c);
            if (c->state != ST_CLOSED && (evs[i].events & EPOLLOUT))
                conn_flush(th, c);
        }
    }
    /* wait for every started handshake to resolve */
    while (th->n_ready + th->n_failed < th->n_conns && !g_stop
           && now_ns() < deadline) {
        struct epoll_event evs[512];
        int n = epoll_wait(th->epfd, evs, 512, 20);
        for (int i = 0; i < n; i++) {
            conn_t *c = evs[i].data.ptr;
            if (c->state == ST_CONNECTING
                && (evs[i].events & (EPOLLOUT | EPOLLERR | EPOLLHUP))) {
                int soerr = 0;
                socklen_t sl = sizeof soerr;
                getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &soerr, &sl);
                if (soerr) { conn_fail(th, c, 1); th->connect_errs++;
                             continue; }
                conn_send_handshake(th, c);
                continue;
            }
            if (evs[i].events & EPOLLIN) conn_rx(th, c);
            if (c->state != ST_CLOSED && (evs[i].events & EPOLLOUT))
                conn_flush(th, c);
        }
    }
}

/* generic event pump for the later phases */
static void pump(thr_t *th, int timeout_ms) {
    struct epoll_event evs[512];
    int n = epoll_wait(th->epfd, evs, 512, timeout_ms);
    for (int i = 0; i < n; i++) {
        conn_t *c = evs[i].data.ptr;
        if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
            conn_rx(th, c);       /* collect what's readable, then fail */
            if (c->state != ST_CLOSED) conn_fail(th, c, 1);
            continue;
        }
        if (evs[i].events & EPOLLIN) conn_rx(th, c);
        /* replies refill the pipeline inside handle_reply; push those
         * bytes now instead of waiting for an EPOLLOUT edge that a
         * never-full socket will not deliver */
        if (c->state != ST_CLOSED
            && (c->woff < c->wlen || (evs[i].events & EPOLLOUT)))
            conn_flush(th, c);
    }
}

static int outstanding(thr_t *th) {
    int tot = 0;
    for (int i = 0; i < th->n_conns; i++)
        if (th->conns[i].state == ST_READY)
            tot += (int)th->conns[i].q_len;
    return tot;
}

/* One-off CREATE of the bare hot path (NODE_EXISTS is fine).  Runs on
 * thread 0 at HOLD entry so only the owning thread ever touches the
 * connection's buffers. */
static void send_ensure_path(thr_t *th) {
    for (int i = 0; i < th->n_conns; i++) {
        conn_t *c = &th->conns[i];
        if (c->state != ST_READY) continue;
        uint8_t b[512]; uint32_t o;
        o = tpl_begin(b, OP_CREATE);
        be32(b + 4, c->next_xid + 1);
        o = tpl_str(b, o, C.path);
        be32(b + o, 1); o += 4;
        b[o++] = 'x';
        be32(b + o, 1); o += 4;
        be32(b + o, 31); o += 4;
        o = tpl_str(b, o, "world");
        o = tpl_str(b, o, "anyone");
        be32(b + o, 0); o += 4;
        o = tpl_finish(b, o);
        if (c->q_len >= (uint32_t)C.pipeline || wbuf_reserve(c, o))
            return;
        c->next_xid++;
        slot_t *s = &c->q[(c->q_head + c->q_len) % C.pipeline];
        s->xid = c->next_xid; s->cls = CLS_CREATE; s->t_ns = now_ns();
        c->q_len++;
        memcpy(c->wbuf + c->wlen, b, o);
        c->wlen += o;
        conn_flush(th, c);
        return;
    }
}

/* The fan-out writer: thread 0 stamps one SET on its first ready
 * connection when main raises the fire flag. */
static void fanout_fire(thr_t *th) {
    if (th->idx != 0) return;
    if (!atomic_exchange_explicit(&g_fanout_fire, 0,
                                  memory_order_acq_rel))
        return;
    for (int i = 0; i < th->n_conns; i++) {
        conn_t *c = &th->conns[i];
        if (c->state != ST_READY) continue;
        if (c->q_len >= (uint32_t)C.pipeline) continue;
        if (!send_op(th, c, CLS_SET)) conn_flush(th, c);
        return;
    }
}

static void *thread_main(void *arg) {
    thr_t *th = arg;
    build_templates(th);
    int last_phase = -1;
    int64_t phase_t0 = 0;
    for (;;) {
        int phase = atomic_load_explicit(&g_phase,
                                         memory_order_acquire);
        if (phase == PH_DONE || g_stop) break;
        if (phase != last_phase) {
            last_phase = phase;
            th->phase_done = 0;
            phase_t0 = now_ns();
            if (phase == PH_CONNECT) {
                phase_connect(th);
                /* the bare hot path must exist before ANY later
                 * phase writes or arms against it; under
                 * --stdio-sync the HOLD window can be milliseconds
                 * (READY out, GO straight back) and a thread parked
                 * in pump() can miss the phase entirely — so the
                 * CREATE rides the tail of connect, which every
                 * thread observes by construction, and its ack is
                 * drained before READY is ever printed */
                if (th->idx == 0 && C.ensure_path) {
                    send_ensure_path(th);
                    int64_t dl = now_ns() + (int64_t)10e9;
                    while (outstanding(th) > 0 && !g_stop
                           && now_ns() < dl)
                        pump(th, 10);
                }
                th->phase_done = PH_CONNECT + 1;
                continue;
            }
            if (phase == PH_ARM) {
                /* cached mode arms the subtree once with a persistent-
                 * recursive ADD_WATCH; classic mode arms the one-shot
                 * data watch via GET_DATA watch=1 */
                int arm_cls = C.cached ? CLS_ADDW : CLS_ARM;
                for (int i = 0; i < th->n_conns; i++) {
                    conn_t *c = &th->conns[i];
                    if (c->state == ST_READY
                        && !send_op(th, c, arm_cls))
                        conn_flush(th, c);
                }
            }
            if (phase == PH_STEADY) {
                for (int i = 0; i < th->n_conns; i++) {
                    conn_t *c = &th->conns[i];
                    if (c->state != ST_READY) continue;
                    if (C.count_per_session > 0)
                        c->quota_left = C.count_per_session;
                    refill(th, c);
                    conn_flush(th, c);
                }
            }
            if (phase == PH_FANOUT) {
                /* steady-window writes consumed one-shot watches, and
                 * full rings dropped the in-reply re-arms: restore
                 * every un-armed conn so run_fanout's rounds fire
                 * against the whole fleet, not the survivors */
                for (int i = 0; i < th->n_conns; i++) {
                    conn_t *c = &th->conns[i];
                    if (c->state == ST_READY && !c->armed
                        && !send_op(th, c, CLS_ARM))
                        conn_flush(th, c);
                }
            }
            if (phase == PH_SETWATCHES) {
                for (int i = 0; i < th->n_conns; i++) {
                    conn_t *c = &th->conns[i];
                    if (c->state == ST_READY
                        && !send_op(th, c, CLS_SETW))
                        conn_flush(th, c);
                }
            }
            if (phase == PH_DRAIN && C.close_sessions) {
                for (int i = 0; i < th->n_conns; i++) {
                    conn_t *c = &th->conns[i];
                    if (c->state == ST_READY
                        && !send_op(th, c, CLS_CLOSE))
                        conn_flush(th, c);
                }
            }
        }
        pump(th, 10);
        int done = 0;
        switch (phase) {
        case PH_HOLD:
            ping_sweep(th, (double)C.session_timeout_ms / 3000.0);
            done = 1;              /* hold ends when main says so */
            break;
        case PH_ARM:
            done = outstanding(th) == 0
                || now_ns() - phase_t0 > (int64_t)30e9;
            break;
        case PH_STEADY: {
            if (C.idle_ping_s > 0) {
                ping_sweep(th, C.idle_ping_s);
                long e = atomic_load_explicit(&g_window_end_ms,
                                              memory_order_relaxed);
                done = (now_ns() - g_t0_ns) / 1000000 >= e;
                break;
            }
            /* top up pipelines (conns whose replies arrived while the
             * window opened late, count-mode stragglers) */
            int chunk = th->n_conns / 16 + 1;
            for (int i = 0; i < chunk; i++) {
                conn_t *c = &th->conns[th->rr++ % th->n_conns];
                if (c->state == ST_READY && c->q_len == 0) {
                    refill(th, c);
                    if (c->wlen) conn_flush(th, c);
                }
            }
            /* cached mode: thread 0 stamps a periodic SET on the hot
             * path so the steady window actually exercises the
             * invalidate -> refill cycle instead of a never-stale
             * cache */
            if (C.cached && th->idx == 0 && C.cached_write_s > 0) {
                int64_t tn = now_ns();
                if (tn - th->t_last_cset_ns >=
                        (int64_t)(C.cached_write_s * 1e9)) {
                    for (int i = 0; i < th->n_conns; i++) {
                        conn_t *c = &th->conns[i];
                        if (c->state != ST_READY) continue;
                        if (c->q_len >= (uint32_t)C.pipeline) continue;
                        if (!send_op(th, c, CLS_SET)) conn_flush(th, c);
                        th->t_last_cset_ns = tn;
                        break;
                    }
                }
            }
            ping_sweep(th, (double)C.session_timeout_ms / 3000.0);
            if (C.count_per_session > 0) {
                int busy = 0;
                for (int i = 0; i < th->n_conns; i++) {
                    conn_t *c = &th->conns[i];
                    if (c->state == ST_READY
                        && (c->quota_left > 0 || c->q_len > 0))
                        busy = 1;
                }
                done = !busy;
            } else {
                long e = atomic_load_explicit(&g_window_end_ms,
                                              memory_order_relaxed);
                int over = (now_ns() - g_t0_ns) / 1000000 >= e;
                done = over && (outstanding(th) == 0
                    || now_ns() - phase_t0 >
                       (int64_t)((C.duration_s + 15.0) * 1e9));
            }
            break;
        }
        case PH_FANOUT:
            fanout_fire(th);
            ping_sweep(th, (double)C.session_timeout_ms / 3000.0);
            done = atomic_load_explicit(&g_fanout_done,
                                        memory_order_relaxed);
            break;
        case PH_SETWATCHES: {
            /* SET_WATCHES acks don't ride the ring; completion is
             * acks-received == sends */
            uint64_t sent = 0;
            for (int i = 0; i < th->n_conns; i++)
                sent += (th->conns[i].t_setw_ns != 0);
            done = th->ops[CLS_SETW] >= sent
                || now_ns() - phase_t0 > (int64_t)120e9;
            break;
        }
        case PH_DRAIN:
            done = outstanding(th) == 0
                || now_ns() - phase_t0 > (int64_t)(C.drain_s * 1e9);
            break;
        default:
            break;
        }
        /* phase+1, not a boolean: main waits for THIS phase's stamp,
         * so a stale flag from the previous phase can't satisfy the
         * next wait.  The stamp is sticky: once a thread has finished
         * the phase it keeps the stamp until g_phase moves on (the
         * entry above clears it).  Clearing it again on a pass where
         * `done` is 0 (PH_CONNECT, whose work ran at entry, reaches
         * `default` on every pass after it) would leave wait_phase,
         * which polls every 10 ms, to catch every thread inside one
         * pass's window: with two threads or more a run hung in the
         * connect phase. */
        if (done)
            th->phase_done = phase + 1;
    }
    return NULL;
}

/* ---- fan-out driver (main thread sequences rounds; thread 0 does
 * the actual SET via the fire flag so only the owning thread ever
 * touches connection buffers) ---- */
static void run_fanout(void) {
    int rounds = C.fanout_sets;
    if (rounds > 4096) rounds = 4096;
    for (int r = 0; r < rounds && !g_stop; r++) {
        /* wait for re-arms to land before firing: the PH_FANOUT entry
         * sweep (round 0) and the in-reply re-arms (later rounds)
         * push the gauge back toward the ready-session count.  The
         * deadline caps stragglers; expect is whatever really armed */
        long want = 0;
        for (int t = 0; t < C.threads; t++) want += T[t].n_ready;
        int64_t arm_dl = now_ns() + (int64_t)5e9;
        long armed = atomic_load(&g_armed_now);
        while (!g_stop && armed < want && now_ns() < arm_dl) {
            struct timespec ts = {0, 2000000};
            nanosleep(&ts, NULL);
            armed = atomic_load(&g_armed_now);
        }
        unsigned long base = atomic_load(&g_fanout_notifs);
        atomic_store(&g_fanout_round, r);
        int64_t t0 = now_ns();
        atomic_store(&g_fanout_fire, 1);
        /* wait for the wave: every armed watcher fires once */
        uint64_t expect = armed > 0 ? (uint64_t)armed : 1;
        int64_t deadline = t0 + (int64_t)(C.watch_wait_s * 1e9);
        unsigned long got = 0;
        while (!g_stop && now_ns() < deadline) {
            got = atomic_load(&g_fanout_notifs) - base;
            if (got >= expect) break;
            struct timespec ts = {0, 2000000};
            nanosleep(&ts, NULL);
        }
        got = atomic_load(&g_fanout_notifs) - base;
        g_fanout_round_ms[r] =
            (double)(now_ns() - t0) / 1e6;
        g_fanout_expected += expect;
        g_fanout_delivered += got;
        g_fanout_rounds_run++;
    }
    atomic_store(&g_fanout_round, -1);
    atomic_store(&g_fanout_done, 1);
}

/* ---- rlimit ---- */
static void raise_nofile(int need) {
    struct rlimit rl;
    getrlimit(RLIMIT_NOFILE, &rl);
    g_nofile_soft0 = (long)rl.rlim_cur;
    long want = need + 256;
    if ((long)rl.rlim_cur < want) {
        rlim_t hard = rl.rlim_max;
        if ((long)hard < want) {
            /* raising the hard limit needs CAP_SYS_RESOURCE and is
             * bounded by /proc/sys/fs/nr_open */
            struct rlimit try_rl = {(rlim_t)want, (rlim_t)want};
            if (setrlimit(RLIMIT_NOFILE, &try_rl) == 0) {
                getrlimit(RLIMIT_NOFILE, &rl);
            } else {
                struct rlimit up = {hard, hard};
                setrlimit(RLIMIT_NOFILE, &up);
                getrlimit(RLIMIT_NOFILE, &rl);
            }
        } else {
            struct rlimit up = {(rlim_t)want, hard};
            setrlimit(RLIMIT_NOFILE, &up);
            getrlimit(RLIMIT_NOFILE, &rl);
        }
    }
    g_nofile_soft = (long)rl.rlim_cur;
    g_nofile_hard = (long)rl.rlim_max;
    long fit = g_nofile_soft - 256;
    if (fit < C.sessions) {
        g_sessions_clamped = 1;
        snprintf(g_binding_constraint, sizeof g_binding_constraint,
                 "RLIMIT_NOFILE: soft/hard %ld/%ld fits %ld sessions "
                 "(wanted %d); raising further needs "
                 "CAP_SYS_RESOURCE and fs.nr_open",
                 g_nofile_soft, g_nofile_hard, fit, C.sessions);
        fprintf(stderr, "zkloadgen: %s\n", g_binding_constraint);
        C.sessions = (int)fit;
        if (C.sessions < 1)
            die("zkloadgen: fd limit leaves no room for sockets");
    }
}

/* ---- JSON summary ---- */
static void put_res(FILE *f, const char *name, res_t *r,
                    uint64_t count, uint64_t errors, int *first) {
    if (!count) return;
    res_sort(r);
    fprintf(f, "%s\"%s\": {\"count\": %" PRIu64
            ", \"errors\": %" PRIu64
            ", \"p50_us\": %.1f, \"p90_us\": %.1f, \"p99_us\": %.1f}",
            *first ? "" : ", ", name, count, errors,
            res_pct(r, 50), res_pct(r, 90), res_pct(r, 99));
    *first = 0;
}

static void report(FILE *f, double steady_s, int connected,
                   double hs_wall_s) {
    uint64_t ops[CLS_N] = {0}, ops_win[CLS_N] = {0};
    uint64_t errs[CLS_N] = {0};
    uint64_t notifs = 0, notif_win = 0, proto = 0, floorv = 0;
    uint64_t cerrs = 0, ioerrs = 0, brx = 0, btx = 0, ntx = 0, nrx = 0;
    int64_t max_zxid = 0, awz = 0;
    uint64_t chits = 0, chits_win = 0, cinv = 0;
    res_t lat[CLS_N], hs, chit, crefill;
    memset(&lat, 0, sizeof lat);
    memset(&hs, 0, sizeof hs);
    memset(&chit, 0, sizeof chit);
    memset(&crefill, 0, sizeof crefill);
    for (int t = 0; t < C.threads; t++) {
        thr_t *th = &T[t];
        for (int k = 0; k < CLS_N; k++) {
            ops[k] += th->ops[k];
            ops_win[k] += th->ops_win[k];
            errs[k] += th->errs_srv[k];
            for (uint64_t i = 0;
                 i < (th->lat[k].n < RES_N ? th->lat[k].n : RES_N);
                 i++)
                res_add(&lat[k], &th->rng, th->lat[k].v[i]);
        }
        for (uint64_t i = 0;
             i < (th->hs.n < RES_N ? th->hs.n : RES_N); i++)
            res_add(&hs, &th->rng, th->hs.v[i]);
        notifs += th->notifications;
        notif_win += th->notif_win;
        proto += th->proto_errs;
        floorv += th->floor_violations;
        cerrs += th->connect_errs;
        ioerrs += th->io_errs;
        brx += th->bytes_rx; btx += th->bytes_tx;
        ntx += th->tx_syscalls; nrx += th->rx_syscalls;
        if (th->max_zxid > max_zxid) max_zxid = th->max_zxid;
        if (th->acked_write_zxid > awz) awz = th->acked_write_zxid;
        chits += th->cache_hits;
        chits_win += th->cache_hits_win;
        cinv += th->cache_invalidations;
        for (uint64_t i = 0;
             i < (th->cache_hit_lat.n < RES_N
                  ? th->cache_hit_lat.n : RES_N); i++)
            res_add(&chit, &th->rng, th->cache_hit_lat.v[i]);
        for (uint64_t i = 0;
             i < (th->cache_refill_lat.n < RES_N
                  ? th->cache_refill_lat.n : RES_N); i++)
            res_add(&crefill, &th->rng, th->cache_refill_lat.v[i]);
    }
    uint64_t win_total = 0, all_total = 0;
    for (int k = 0; k < CLS_N; k++) {
        if (k == CLS_PING && C.idle_ping_s <= 0) { }
        win_total += ops_win[k];
        all_total += ops[k];
    }
    fprintf(f, "{\"tool\": \"zkloadgen\", \"sessions\": %d, "
            "\"connected\": %d, \"threads\": %d, \"pipeline\": %d",
            C.sessions, connected, C.threads, C.pipeline);
    fprintf(f, ", \"client_capped\": false");
    if (steady_s > 0)
        fprintf(f, ", \"window\": {\"secs\": %.3f, \"ops\": %" PRIu64
                ", \"ops_per_sec\": %.1f, \"notifications\": %" PRIu64
                "}", steady_s, win_total,
                (double)win_total / steady_s, notif_win);
    fprintf(f, ", \"ops\": {");
    int first = 1;
    for (int k = 0; k < CLS_N; k++)
        put_res(f, CLS_NAME[k], &lat[k], ops[k], errs[k], &first);
    fprintf(f, "}");
    fprintf(f, ", \"total_ops\": %" PRIu64, all_total);
    if (hs.n) {
        res_sort(&hs);
        fprintf(f, ", \"handshake\": {\"connected\": %d, "
                "\"wall_s\": %.3f, \"rate_per_sec\": %.1f, "
                "\"p50_us\": %.1f, \"p99_us\": %.1f, "
                "\"failures\": %" PRIu64 "}",
                connected, hs_wall_s,
                hs_wall_s > 0 ? connected / hs_wall_s : 0.0,
                res_pct(&hs, 50), res_pct(&hs, 99), cerrs);
    }
    if (g_fanout_rounds_run) {
        double tot = 0, mx = 0;
        for (int i = 0; i < g_fanout_rounds_run; i++) {
            tot += g_fanout_round_ms[i];
            if (g_fanout_round_ms[i] > mx) mx = g_fanout_round_ms[i];
        }
        fprintf(f, ", \"fanout\": {\"rounds\": %d, \"expected\": %"
                PRIu64 ", \"delivered\": %" PRIu64
                ", \"round_ms_mean\": %.2f, \"round_ms_max\": %.2f"
                ", \"notifs_per_sec\": %.1f}",
                g_fanout_rounds_run, g_fanout_expected,
                g_fanout_delivered, tot / g_fanout_rounds_run, mx,
                tot > 0 ? g_fanout_delivered / (tot / 1000.0) : 0.0);
    }
    if (ops[CLS_SETW] && g_setw_storm_s > 0)
        fprintf(f, ", \"setwatches_storm\": {\"acks\": %" PRIu64
                ", \"secs\": %.3f, \"acks_per_sec\": %.1f}",
                ops[CLS_SETW], g_setw_storm_s,
                ops[CLS_SETW] / g_setw_storm_s);
    fprintf(f, ", \"notifications\": %" PRIu64, notifs);
    if (C.cached) {
        /* a miss is a read that had to go to the wire: the served
         * GET/EXISTS/LIST ops.  hit_ratio over the steady window. */
        uint64_t miss_win = ops_win[CLS_GET] + ops_win[CLS_EXISTS]
            + ops_win[CLS_LIST];
        uint64_t reads_win = chits_win + miss_win;
        res_sort(&chit);
        res_sort(&crefill);
        fprintf(f, ", \"cache\": {\"hits\": %" PRIu64
                ", \"hits_win\": %" PRIu64
                ", \"wire_reads_win\": %" PRIu64
                ", \"hit_ratio\": %.6f"
                ", \"invalidations\": %" PRIu64
                ", \"hit_p50_us\": %.3f, \"hit_p99_us\": %.3f"
                ", \"refill_p50_us\": %.1f, \"refill_p99_us\": %.1f",
                chits, chits_win, miss_win,
                reads_win ? (double)chits_win / (double)reads_win : 0.0,
                cinv,
                res_pct(&chit, 50), res_pct(&chit, 99),
                res_pct(&crefill, 50), res_pct(&crefill, 99));
        if (steady_s > 0)
            fprintf(f, ", \"hits_per_sec\": %.1f",
                    (double)chits_win / steady_s);
        fprintf(f, "}");
    }
    fprintf(f, ", \"zxid\": {\"floor_violations\": %" PRIu64
            ", \"max_zxid\": %" PRId64
            ", \"acked_write_max_zxid\": %" PRId64 "}",
            floorv, max_zxid, awz);
    fprintf(f, ", \"errors\": {\"connect\": %" PRIu64 ", \"io\": %"
            PRIu64 ", \"proto\": %" PRIu64 "}",
            cerrs, ioerrs, proto);
    fprintf(f, ", \"syscalls\": {\"tx\": %" PRIu64 ", \"rx\": %"
            PRIu64 ", \"bytes_tx\": %" PRIu64 ", \"bytes_rx\": %"
            PRIu64 "}", ntx, nrx, btx, brx);
    fprintf(f, ", \"caps\": {\"nofile_initial\": %ld, "
            "\"nofile_soft\": %ld, \"nofile_hard\": %ld, "
            "\"sessions_clamped\": %s, \"bind_no_port\": %s, "
            "\"src_addrs\": %d",
            g_nofile_soft0, g_nofile_soft, g_nofile_hard,
            g_sessions_clamped ? "true" : "false",
            g_bind_no_port_ok > 0 ? "true"
            : (g_bind_no_port_ok == 0 ? "false" : "null"),
            C.src_addrs);
    if (g_binding_constraint[0])
        fprintf(f, ", \"binding_constraint\": \"%s\"",
                g_binding_constraint);
    fprintf(f, "}}\n");
}

/* ---- argument parsing ---- */
static void parse_mix(const char *spec) {
    memset(C.weights, 0, sizeof C.weights);
    char buf[256];
    snprintf(buf, sizeof buf, "%s", spec);
    for (char *tok = strtok(buf, ","); tok; tok = strtok(NULL, ",")) {
        char *eq = strchr(tok, '=');
        if (!eq) die("bad --mix token %s", tok);
        *eq = 0;
        int w = atoi(eq + 1);
        if (!strcmp(tok, "get")) C.weights[CLS_GET] = w;
        else if (!strcmp(tok, "exists")) C.weights[CLS_EXISTS] = w;
        else if (!strcmp(tok, "list")) C.weights[CLS_LIST] = w;
        else if (!strcmp(tok, "create")) C.weights[CLS_CREATE] = w;
        else if (!strcmp(tok, "set")) C.weights[CLS_SET] = w;
        else die("unknown op %s in --mix (get/exists/list/create/set)",
                 tok);
    }
    int tot = 0;
    for (int i = 0; i < CLS_N; i++) tot += C.weights[i];
    if (!tot) die("--mix has zero total weight");
}

static void parse_servers(const char *spec) {
    char buf[1024];
    snprintf(buf, sizeof buf, "%s", spec);
    for (char *tok = strtok(buf, ","); tok; tok = strtok(NULL, ",")) {
        char *colon = strrchr(tok, ':');
        if (!colon) die("bad server %s (want HOST:PORT)", tok);
        *colon = 0;
        if (C.n_servers >= 64) die("too many servers");
        struct sockaddr_in *sa = &C.servers[C.n_servers++];
        memset(sa, 0, sizeof *sa);
        sa->sin_family = AF_INET;
        sa->sin_port = htons((uint16_t)atoi(colon + 1));
        if (inet_pton(AF_INET, tok, &sa->sin_addr) != 1)
            die("bad server address %s (IPv4 literal required)", tok);
    }
    if (!C.n_servers) die("--servers is required");
}

static double arg_d(int argc, char **argv, int *i) {
    if (*i + 1 >= argc) die("%s needs a value", argv[*i]);
    return atof(argv[++*i]);
}
static int arg_i(int argc, char **argv, int *i) {
    if (*i + 1 >= argc) die("%s needs a value", argv[*i]);
    return atoi(argv[++*i]);
}
static const char *arg_s(int argc, char **argv, int *i) {
    if (*i + 1 >= argc) die("%s needs a value", argv[*i]);
    return argv[++*i];
}

static void wait_phase(int ph) {
    for (;;) {
        int all = 1;
        for (int t = 0; t < C.threads; t++)
            if (T[t].phase_done != ph + 1) all = 0;
        if (all || g_stop) return;
        struct timespec ts = {0, 10000000};
        nanosleep(&ts, NULL);
    }
}

int main(int argc, char **argv) {
    memset(&C, 0, sizeof C);
    C.sessions = 100;
    C.threads = 0;
    C.duration_s = 5.0;
    C.pipeline = 16;
    C.weights[CLS_GET] = 100;
    C.data_len = 128;
    snprintf(C.path, sizeof C.path, "/bench");
    C.ensure_path = 1;
    C.session_timeout_ms = 120000;
    C.connect_timeout_s = 120.0;
    C.watch_wait_s = 30.0;
    C.drain_s = 10.0;
    C.src_addrs = 0;
    for (int i = 1; i < argc; i++) {
        const char *a = argv[i];
        if (!strcmp(a, "--servers")) parse_servers(arg_s(argc, argv,
                                                         &i));
        else if (!strcmp(a, "--sessions"))
            C.sessions = arg_i(argc, argv, &i);
        else if (!strcmp(a, "--threads"))
            C.threads = arg_i(argc, argv, &i);
        else if (!strcmp(a, "--duration"))
            C.duration_s = arg_d(argc, argv, &i);
        else if (!strcmp(a, "--pipeline"))
            C.pipeline = arg_i(argc, argv, &i);
        else if (!strcmp(a, "--count"))
            C.count_per_session = arg_i(argc, argv, &i);
        else if (!strcmp(a, "--ramp")) C.ramp = arg_d(argc, argv, &i);
        else if (!strcmp(a, "--idle-ping"))
            C.idle_ping_s = arg_d(argc, argv, &i);
        else if (!strcmp(a, "--mix")) parse_mix(arg_s(argc, argv, &i));
        else if (!strcmp(a, "--arm-watch")) C.arm_watch = 1;
        else if (!strcmp(a, "--fanout-sets"))
            C.fanout_sets = arg_i(argc, argv, &i);
        else if (!strcmp(a, "--watch-wait"))
            C.watch_wait_s = arg_d(argc, argv, &i);
        else if (!strcmp(a, "--setwatches-storm")) C.setwatches_storm
            = 1;
        else if (!strcmp(a, "--data")) C.data_len = arg_i(argc, argv,
                                                          &i);
        else if (!strcmp(a, "--path"))
            snprintf(C.path, sizeof C.path, "%s", arg_s(argc, argv,
                                                        &i));
        else if (!strcmp(a, "--no-ensure-path")) C.ensure_path = 0;
        else if (!strcmp(a, "--session-timeout"))
            C.session_timeout_ms = arg_i(argc, argv, &i);
        else if (!strcmp(a, "--connect-timeout"))
            C.connect_timeout_s = arg_d(argc, argv, &i);
        else if (!strcmp(a, "--stdio-sync")) C.stdio_sync = 1;
        else if (!strcmp(a, "--src-addrs"))
            C.src_addrs = arg_i(argc, argv, &i);
        else if (!strcmp(a, "--close-sessions")) C.close_sessions = 1;
        else if (!strcmp(a, "--drain"))
            C.drain_s = arg_d(argc, argv, &i);
        else if (!strcmp(a, "--quiet")) C.quiet = 1;
        else if (!strcmp(a, "--cached")) C.cached = 1;
        else if (!strcmp(a, "--cached-write-ms"))
            C.cached_write_s = arg_d(argc, argv, &i) / 1000.0;
        else die("unknown flag %s", a);
    }
    if (!C.n_servers) die("--servers HOST:PORT[,HOST:PORT] required");
    if (C.sessions < 1) die("--sessions must be >= 1");
    if (C.pipeline < 1) C.pipeline = 1;
    if (C.cached && C.cached_write_s <= 0)
        C.cached_write_s = 0.1;  /* 10 invalidations/s default churn */
    if (C.data_len > 400) C.data_len = 400;  /* template fits 512 */
    if (C.threads <= 0) {
        long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
        C.threads = (int)(ncpu < 1 ? 1 : (ncpu > 8 ? 8 : ncpu));
    }
    if (C.threads > C.sessions) C.threads = C.sessions;
    if (C.src_addrs <= 0) {
        /* auto: spread when a loopback target would exhaust one
         * source address's ~28k ephemeral ports */
        int per = C.sessions / C.n_servers + 1;
        C.src_addrs = per > 20000 ? per / 20000 + 1 : 1;
        if (C.src_addrs > 200) C.src_addrs = 200;
    }
    raise_nofile(C.sessions);
    signal(SIGINT, on_sigint);
    signal(SIGPIPE, SIG_IGN);

    /* thread setup */
    T = calloc((size_t)C.threads, sizeof(thr_t));
    if (!T) die("oom");
    int per = C.sessions / C.threads;
    int extra = C.sessions - per * C.threads;
    for (int t = 0; t < C.threads; t++) {
        thr_t *th = &T[t];
        th->idx = t;
        th->rng = 0x9e3779b97f4a7c15ULL ^ (uint64_t)(t + 1) * 0x100001b3;
        th->n_conns = per + (t < extra ? 1 : 0);
        th->conns = calloc((size_t)th->n_conns, sizeof(conn_t));
        th->scratch = malloc(RXCHUNK);
        th->epfd = epoll_create1(0);
        if (!th->conns || !th->scratch || th->epfd < 0)
            die("oom/epoll");
        for (int i = 0; i < th->n_conns; i++) {
            th->conns[i].q = calloc((size_t)C.pipeline, sizeof(slot_t));
            if (!th->conns[i].q) die("oom");
        }
    }

    g_t0_ns = now_ns();
    atomic_store(&g_phase, PH_CONNECT);
    for (int t = 0; t < C.threads; t++)
        pthread_create(&T[t].tid, NULL, thread_main, &T[t]);

    /* main: phase sequencing */
    wait_phase(PH_CONNECT);

    int connected = 0;
    int64_t first_ready = 0, last_ready = 0;
    for (int t = 0; t < C.threads; t++) {
        connected += T[t].n_ready;
        if (T[t].first_ready_ns
            && (!first_ready || T[t].first_ready_ns < first_ready))
            first_ready = T[t].first_ready_ns;
        if (T[t].last_ready_ns > last_ready)
            last_ready = T[t].last_ready_ns;
    }
    double hs_wall_s = connected
        ? (double)(last_ready - g_t0_ns) / 1e9 : 0.0;
    if (!connected && C.sessions > 0) {
        fprintf(stderr, "zkloadgen: no session connected\n");
        report(stdout, 0, 0, 0);
        return EXIT_CONNECT;
    }

    /* HOLD: thread 0 sends the ensure-path CREATE (NODE_EXISTS is
     * fine); every thread keeps sessions alive with pings */
    atomic_store(&g_phase, PH_HOLD);
    if (C.stdio_sync) {
        printf("READY %d\n", connected);
        fflush(stdout);
        char line[64];
        while (fgets(line, sizeof line, stdin))
            if (!strncmp(line, "GO", 2)) break;
    } else {
        struct timespec ts = {0, 200000000};
        nanosleep(&ts, NULL);   /* let ensure-path settle */
    }

    if (C.arm_watch || C.fanout_sets || C.cached) {
        atomic_store(&g_phase, PH_ARM);
        wait_phase(PH_ARM);
    }

    double steady_s = 0.0;
    if (C.count_per_session > 0 || C.duration_s > 0) {
        int64_t t0 = now_ns();
        long start_ms = (t0 - g_t0_ns) / 1000000;
        atomic_store(&g_window_start_ms, start_ms);
        atomic_store(&g_window_end_ms,
                     C.count_per_session > 0
                     ? start_ms + 24L * 3600 * 1000
                     : start_ms + (long)(C.duration_s * 1000));
        atomic_store(&g_phase, PH_STEADY);
        wait_phase(PH_STEADY);
        steady_s = (double)(now_ns() - t0) / 1e9;
        if (C.count_per_session > 0)
            atomic_store(&g_window_end_ms,
                         (now_ns() - g_t0_ns) / 1000000);
    }

    if (C.fanout_sets > 0) {
        atomic_store(&g_phase, PH_FANOUT);
        run_fanout();
        wait_phase(PH_FANOUT);
    }

    if (C.setwatches_storm) {
        int64_t t0 = now_ns();
        atomic_store(&g_phase, PH_SETWATCHES);
        wait_phase(PH_SETWATCHES);
        g_setw_storm_s = (double)(now_ns() - t0) / 1e9;
    }

    atomic_store(&g_phase, PH_DRAIN);
    wait_phase(PH_DRAIN);
    atomic_store(&g_phase, PH_DONE);
    for (int t = 0; t < C.threads; t++)
        pthread_join(T[t].tid, NULL);

    report(stdout, steady_s, connected, hs_wall_s);
    uint64_t floorv = 0, proto = 0;
    for (int t = 0; t < C.threads; t++) {
        floorv += T[t].floor_violations;
        proto += T[t].proto_errs;
    }
    if (floorv) return EXIT_ZXID_FLOOR;
    if (proto) return EXIT_PROTO;
    return EXIT_OK;
}
