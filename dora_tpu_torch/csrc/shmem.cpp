// dora-tpu native shared-memory layer.
//
// Two facilities, exposed through a C ABI consumed from Python via ctypes
// and from future C/C++ node APIs directly:
//
//  1. Raw shared-memory *regions* — the zero-copy payload path. A sender
//     allocates a region, writes an Arrow IPC stream into it, and passes the
//     region id through the daemon; receivers map it read-only.
//
//  2. A synchronous request-reply *channel* living inside one region — the
//     node<->daemon control/event transport in shmem mode. Semantics follow
//     the reference implementation (dora-rs shared-memory-server,
//     libraries/shared-memory-server/src/channel.rs:24-246): two one-shot
//     events (server-side / client-side), a disconnect flag, and a length
//     field, all with acquire/release ordering, plus a payload area. Here
//     the events are futex words (Linux) instead of the reference's
//     raw-sync events.
//
// Build: dora_tpu_torch/native.py runs g++ -O2 -shared -fPIC -std=c++17 on it
// into dora_tpu_torch/_build/ at first use (-lrt -pthread).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// futex helpers
// ---------------------------------------------------------------------------

int futex(std::atomic<uint32_t>* uaddr, int op, uint32_t val,
          const struct timespec* timeout) {
  return syscall(SYS_futex, reinterpret_cast<uint32_t*>(uaddr), op, val,
                 timeout, nullptr, 0);
}

// A one-shot event usable across processes: set() wakes the (single) waiter;
// wait() blocks until set, then consumes the signal.
struct Event {
  std::atomic<uint32_t> word;

  void set() {
    word.store(1, std::memory_order_release);
    futex(&word, FUTEX_WAKE, 1, nullptr);
  }

  // timeout_ms < 0: wait forever. Returns 0 on signal, -1 on timeout.
  int wait(int64_t timeout_ms) {
    // Bounded spin before sleeping: request-reply peers typically
    // answer within tens of microseconds, while a futex sleep + wake
    // costs ~50-150 us of scheduler latency. ~15 us of polling (cheap
    // relaxed loads; CAS only on observed signal) catches the hot case
    // without kernel involvement and costs a parked waiter almost
    // nothing (paid once per wait call, not per parked second).
    for (int i = 0; i < 4000; ++i) {
      if (word.load(std::memory_order_relaxed) == 1) {
        uint32_t expected = 1;
        if (word.compare_exchange_strong(expected, 0,
                                         std::memory_order_acquire)) {
          return 0;
        }
      }
#if defined(__x86_64__) || defined(__i386__)
      __builtin_ia32_pause();
#else
      std::atomic_thread_fence(std::memory_order_seq_cst);
#endif
    }
    struct timespec ts;
    struct timespec* tsp = nullptr;
    if (timeout_ms >= 0) {
      ts.tv_sec = timeout_ms / 1000;
      ts.tv_nsec = (timeout_ms % 1000) * 1000000L;
      tsp = &ts;
    }
    for (;;) {
      uint32_t expected = 1;
      if (word.compare_exchange_strong(expected, 0,
                                       std::memory_order_acquire)) {
        return 0;
      }
      int rc = futex(&word, FUTEX_WAIT, 0, tsp);
      if (rc == -1 && errno == ETIMEDOUT) return -1;
      // EINTR / EAGAIN (value changed): loop and re-check.
    }
  }
};

// ---------------------------------------------------------------------------
// Channel header layout (inside the shared region)
// ---------------------------------------------------------------------------

constexpr uint32_t kMagic = 0xD02A79C2;

struct ChannelHeader {
  uint32_t magic;
  uint32_t capacity;                  // payload area size
  Event server_event;                 // signaled when a request is ready
  Event client_event;                 // signaled when a reply is ready
  // Flow control: one pending flag + consumed signal per direction, so
  // back-to-back fire-and-forget sends (no reply expected, e.g.
  // SendMessage bursts) block until the receiver drained the slot instead
  // of silently overwriting it. The payload area itself stays shared,
  // which is safe under the single-requester discipline: replies only
  // exist for the request currently being awaited.
  Event c2s_free;                     // client->server slot consumed
  Event s2c_free;                     // server->client slot consumed
  std::atomic<uint32_t> c2s_pending;
  std::atomic<uint32_t> s2c_pending;
  std::atomic<uint32_t> disconnected; // either side sets on close
  std::atomic<uint64_t> len;          // payload length of the pending message
  // payload follows, 64-byte aligned
};

constexpr size_t kPayloadOffset = (sizeof(ChannelHeader) + 63) & ~size_t(63);

struct Region {
  int fd;
  void* ptr;
  size_t size;
  char name[256];
  bool owner;
};

Region* map_region(const char* name, size_t size, bool create) {
  int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, (off_t)size) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  if (!create) {
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    size = (size_t)st.st_size;
  }
  void* ptr = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (ptr == MAP_FAILED) {
    close(fd);
    if (create) shm_unlink(name);
    return nullptr;
  }
  Region* r = new Region();
  r->fd = fd;
  r->ptr = ptr;
  r->size = size;
  r->owner = create;
  strncpy(r->name, name, sizeof(r->name) - 1);
  return r;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Raw regions (payload path)
// ---------------------------------------------------------------------------

void* dtp_region_create(const char* name, uint64_t size) {
  return map_region(name, size, true);
}

void* dtp_region_open(const char* name) { return map_region(name, 0, false); }

void* dtp_region_ptr(void* region) { return static_cast<Region*>(region)->ptr; }

uint64_t dtp_region_size(void* region) {
  return static_cast<Region*>(region)->size;
}

// Unmap; if unlink != 0, also remove the name from the system.
void dtp_region_close(void* region, int unlink_it) {
  Region* r = static_cast<Region*>(region);
  munmap(r->ptr, r->size);
  close(r->fd);
  if (unlink_it) shm_unlink(r->name);
  delete r;
}

int dtp_region_unlink(const char* name) { return shm_unlink(name); }

// ---------------------------------------------------------------------------
// Request-reply channel
// ---------------------------------------------------------------------------

void* dtp_channel_create(const char* name, uint32_t capacity) {
  Region* r = map_region(name, kPayloadOffset + capacity, true);
  if (!r) return nullptr;
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  memset(h, 0, sizeof(ChannelHeader));
  h->capacity = capacity;
  std::atomic_thread_fence(std::memory_order_release);
  h->magic = kMagic;
  return r;
}

void* dtp_channel_open(const char* name) {
  Region* r = map_region(name, 0, false);
  if (!r) return nullptr;
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  if (r->size < kPayloadOffset || h->magic != kMagic) {
    dtp_region_close(r, 0);
    return nullptr;
  }
  return r;
}

uint32_t dtp_channel_capacity(void* chan) {
  auto* h = static_cast<ChannelHeader*>(static_cast<Region*>(chan)->ptr);
  return h->capacity;
}

// Non-blocking send: write a message and signal the peer, or return -1
// immediately when the previous message in this direction is still
// unconsumed. is_server: 1 when the daemon side sends (signals
// client_event), 0 when the node side sends. Lets the daemon's event loop
// send replies inline (the requester is parked in recv, so the slot is
// free) without risking a blocked loop on a stuck peer.
// Returns 0 ok, -1 would block, -2 disconnected, -3 message too large.
int dtp_channel_try_send(void* chan, const uint8_t* data, uint64_t len,
                         int is_server) {
  Region* r = static_cast<Region*>(chan);
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  if (len > h->capacity) return -3;
  if (h->disconnected.load(std::memory_order_acquire)) return -2;
  auto& pending = is_server ? h->s2c_pending : h->c2s_pending;
  uint32_t expected = 0;
  if (!pending.compare_exchange_strong(expected, 1,
                                       std::memory_order_acq_rel)) {
    return -1;
  }
  memcpy(static_cast<uint8_t*>(r->ptr) + kPayloadOffset, data, len);
  h->len.store(len, std::memory_order_release);
  (is_server ? h->client_event : h->server_event).set();
  return 0;
}

// Blocking send: retries try_send until the direction's slot frees up.
// Returns 0 ok, -2 disconnected, -3 message too large.
int dtp_channel_send(void* chan, const uint8_t* data, uint64_t len,
                     int is_server) {
  auto* h = static_cast<ChannelHeader*>(static_cast<Region*>(chan)->ptr);
  auto& free_ev = is_server ? h->s2c_free : h->c2s_free;
  for (;;) {
    int rc = dtp_channel_try_send(chan, data, len, is_server);
    if (rc != -1) return rc;
    free_ev.wait(100);  // slice so disconnects are noticed
  }
}

// Wait for a message from the peer and copy it into out (size out_cap).
// Returns payload length (>=0), -1 timeout, -2 disconnected, -4 buffer too
// small (message preserved; call again with a bigger buffer).
int64_t dtp_channel_recv(void* chan, uint8_t* out, uint64_t out_cap,
                         int64_t timeout_ms, int is_server) {
  Region* r = static_cast<Region*>(chan);
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  Event& ev = is_server ? h->server_event : h->client_event;
  // Poll in slices so a disconnect set between waits is noticed. A message
  // delivered before the peer disconnected must still be consumable, so the
  // event is always drained before the disconnect flag is honored.
  for (;;) {
    if (ev.wait(0) == 0) break;
    if (h->disconnected.load(std::memory_order_acquire)) return -2;
    int64_t slice = 100;
    if (timeout_ms >= 0 && timeout_ms < slice) slice = timeout_ms;
    int rc = ev.wait(slice);
    if (rc == 0) break;
    if (timeout_ms >= 0) {
      timeout_ms -= slice;
      if (timeout_ms <= 0) return -1;
    }
  }
  uint64_t len = h->len.load(std::memory_order_acquire);
  if (len > out_cap) {
    ev.set();  // put the signal back
    return -4;
  }
  memcpy(out, static_cast<uint8_t*>(r->ptr) + kPayloadOffset, len);
  // Release the sender's slot (the incoming direction from our view).
  auto& pending = is_server ? h->c2s_pending : h->s2c_pending;
  auto& free_ev = is_server ? h->c2s_free : h->s2c_free;
  pending.store(0, std::memory_order_release);
  free_ev.set();
  return (int64_t)len;
}

// Zero-copy variant: returns a pointer to the payload inside the mapped
// region (valid until the next send on this channel).
int64_t dtp_channel_recv_ptr(void* chan, const uint8_t** out,
                             int64_t timeout_ms, int is_server) {
  Region* r = static_cast<Region*>(chan);
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  Event& ev = is_server ? h->server_event : h->client_event;
  for (;;) {
    if (ev.wait(0) == 0) break;  // drain pending message before disconnect
    if (h->disconnected.load(std::memory_order_acquire)) return -2;
    int64_t slice = 100;
    if (timeout_ms >= 0 && timeout_ms < slice) slice = timeout_ms;
    int rc = ev.wait(slice);
    if (rc == 0) break;
    if (timeout_ms >= 0) {
      timeout_ms -= slice;
      if (timeout_ms <= 0) return -1;
    }
  }
  // NOTE: the sender's slot is NOT released here — the caller still reads
  // the payload in place. It is released by dtp_channel_recv_done (or the
  // next copying recv).
  *out = static_cast<uint8_t*>(r->ptr) + kPayloadOffset;
  return (int64_t)h->len.load(std::memory_order_acquire);
}

// Release the in-place payload obtained from dtp_channel_recv_ptr.
void dtp_channel_recv_done(void* chan, int is_server) {
  Region* r = static_cast<Region*>(chan);
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  auto& pending = is_server ? h->c2s_pending : h->s2c_pending;
  auto& free_ev = is_server ? h->c2s_free : h->s2c_free;
  pending.store(0, std::memory_order_release);
  free_ev.set();
}

// Mark disconnected and wake any waiter on both sides (reference: disconnect
// protocol on Drop, channel.rs:221-246).
void dtp_channel_disconnect(void* chan) {
  Region* r = static_cast<Region*>(chan);
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  h->disconnected.store(1, std::memory_order_release);
  futex(&h->server_event.word, FUTEX_WAKE, INT32_MAX, nullptr);
  futex(&h->client_event.word, FUTEX_WAKE, INT32_MAX, nullptr);
  futex(&h->c2s_free.word, FUTEX_WAKE, INT32_MAX, nullptr);
  futex(&h->s2c_free.word, FUTEX_WAKE, INT32_MAX, nullptr);
}

int dtp_channel_is_disconnected(void* chan) {
  Region* r = static_cast<Region*>(chan);
  auto* h = static_cast<ChannelHeader*>(r->ptr);
  return (int)h->disconnected.load(std::memory_order_acquire);
}

void dtp_channel_close(void* chan, int unlink_it) {
  dtp_channel_disconnect(chan);
  dtp_region_close(chan, unlink_it);
}

}  // extern "C"
