// graftshm: slab arena + SCM_RIGHTS fd passing for the shared-memory
// object plane.
//
// The arena hands out tmpfs-backed "shmslab-<seq>" files from the store
// directory. Slab names are stable for the life of the file — a sealed
// object's store path IS its slab path, never renamed — so a client that
// mapped the slab at CREATE time keeps a coherent view through SEAL and
// GET (MAP_SHARED mappings of one inode always see current content).
// Recycled slabs are kept on an exact-size free list so a steady-state
// put workload reuses warm pages instead of faulting fresh ones: on this
// host a cold tmpfs first-touch write runs ~1.3 GiB/s while a warm-slab
// copy runs at the memcpy ceiling (~7.5 GiB/s) — slab reuse is where the
// put-bandwidth win actually comes from.
//
// Allocation uses posix_fallocate so "no space" is a clean -2 at CREATE
// time instead of a SIGBUS in the client when it touches a sparse page;
// the Python side falls back to the graftcopy path whose store admission
// can evict.
//
// Locking: a single arena mutex guards the free list. The store calls
// into the arena from EraseObject (slab recycler callback) while holding
// the store mutex; the arena never calls back into the store, so the
// store.mu -> arena.mu order is acyclic. An over-cap recycle lands in a
// single holdover slot (see Arena::holdover_path) and only the slab it
// displaces is unlinked — a cheap tmpfs unlink, done after the mutex
// drops.

#include "shm_core.h"

#include <errno.h>
#include <fcntl.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Arena {
  std::string dir;
  uint64_t max_free_bytes = 0;
  uint64_t free_bytes = 0;
  uint64_t reuses = 0;
  uint64_t seq = 0;
  std::mutex mu;
  // Exact-size buckets: size -> slab paths available for reuse.
  std::unordered_map<uint64_t, std::vector<std::string>> free_slabs;
  // Single over-cap holdover: the most recently recycled slab that did
  // not fit under the retention cap. A put/free loop on an object
  // bigger than the whole cap (e.g. a 1 GiB array against a 512 MiB
  // cap) would otherwise fault fresh pages every iteration — on this
  // host cold tmpfs first-touch runs ~25x slower than a warm rewrite,
  // so one resident slab beyond the cap buys the entire bandwidth win
  // (graftcopy's scratch-inode trick, arena-side). Bounded to exactly
  // one slab: a new over-cap recycle unlinks the previous holdover.
  std::string holdover_path;
  uint64_t holdover_size = 0;
};

}  // namespace

extern "C" {

void* shm_arena_create(const char* dir, uint64_t max_free_bytes) {
  Arena* a = new Arena();
  a->dir = dir;
  a->max_free_bytes = max_free_bytes;
  return a;
}

void shm_arena_destroy(void* arena) {
  Arena* a = static_cast<Arena*>(arena);
  if (a == nullptr) return;
  {
    std::lock_guard<std::mutex> lock(a->mu);
    for (auto& bucket : a->free_slabs) {
      for (const std::string& path : bucket.second) ::unlink(path.c_str());
    }
    a->free_slabs.clear();
    a->free_bytes = 0;
    if (!a->holdover_path.empty()) ::unlink(a->holdover_path.c_str());
  }
  delete a;
}

int shm_arena_acquire(void* arena, uint64_t size, char* out_path,
                      int path_cap, int* reused_out) {
  Arena* a = static_cast<Arena*>(arena);
  if (reused_out != nullptr) *reused_out = 0;
  // Reuse pass: pop exact-size slabs until one opens. A slab can go
  // stale if something swept the store dir underneath us; treat a
  // failed open as "drop and try the next".
  for (;;) {
    std::string path;
    {
      std::lock_guard<std::mutex> lock(a->mu);
      auto it = a->free_slabs.find(size);
      if (it == a->free_slabs.end() || it->second.empty()) break;
      path = std::move(it->second.back());
      it->second.pop_back();
      if (it->second.empty()) a->free_slabs.erase(it);
      a->free_bytes -= size;
    }
    int fd = ::open(path.c_str(), O_RDWR | O_CLOEXEC);
    if (fd < 0) continue;  // stale entry; already unlinked by a sweeper
    int n = std::snprintf(out_path, (size_t)path_cap, "%s", path.c_str());
    if (n < 0 || n >= path_cap) {
      ::close(fd);
      ::unlink(path.c_str());
      return -3;
    }
    {
      std::lock_guard<std::mutex> lock(a->mu);
      a->reuses += 1;
    }
    if (reused_out != nullptr) *reused_out = 1;
    return fd;
  }
  // Over-cap holdover: same exact-size contract as the buckets, same
  // stale handling (a failed open falls through to a fresh slab).
  {
    std::string path;
    {
      std::lock_guard<std::mutex> lock(a->mu);
      if (a->holdover_size == size && !a->holdover_path.empty()) {
        path = std::move(a->holdover_path);
        a->holdover_path.clear();
        a->holdover_size = 0;
      }
    }
    if (!path.empty()) {
      int fd = ::open(path.c_str(), O_RDWR | O_CLOEXEC);
      if (fd >= 0) {
        int n = std::snprintf(out_path, (size_t)path_cap, "%s", path.c_str());
        if (n < 0 || n >= path_cap) {
          ::close(fd);
          ::unlink(path.c_str());
          return -3;
        }
        {
          std::lock_guard<std::mutex> lock(a->mu);
          a->reuses += 1;
        }
        if (reused_out != nullptr) *reused_out = 1;
        return fd;
      }
    }
  }
  // Fresh slab.
  uint64_t seq;
  {
    std::lock_guard<std::mutex> lock(a->mu);
    seq = ++a->seq;
  }
  char path[512];
  int n = std::snprintf(path, sizeof(path), "%s/shmslab-%llu", a->dir.c_str(),
                        (unsigned long long)seq);
  if (n < 0 || n >= (int)sizeof(path) || n >= path_cap) return -3;
  int fd = ::open(path, O_CREAT | O_EXCL | O_RDWR | O_CLOEXEC, 0600);
  if (fd < 0) return -3;
  // posix_fallocate (not ftruncate): reserve the pages now so a full
  // tmpfs is a clean error here, not a SIGBUS in the mapped client.
  int rc = ::posix_fallocate(fd, 0, (off_t)size);
  if (rc != 0) {
    ::close(fd);
    ::unlink(path);
    // EFBIG joins ENOSPC/EDQUOT: all mean "this allocation cannot be
    // satisfied" and the caller should take the fallback path.
    return (rc == ENOSPC || rc == EDQUOT || rc == EFBIG) ? -2 : -3;
  }
  std::memcpy(out_path, path, (size_t)n + 1);
  return fd;
}

void shm_arena_recycle(void* arena, const char* path, uint64_t size) {
  Arena* a = static_cast<Arena*>(arena);
  std::string evict;
  {
    std::lock_guard<std::mutex> lock(a->mu);
    if (a->free_bytes + size <= a->max_free_bytes) {
      a->free_slabs[size].push_back(std::string(path));
      a->free_bytes += size;
      return;
    }
    evict = std::move(a->holdover_path);
    a->holdover_path = path;
    a->holdover_size = size;
  }
  if (!evict.empty()) ::unlink(evict.c_str());
}

uint64_t shm_arena_free_bytes(void* arena) {
  Arena* a = static_cast<Arena*>(arena);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->free_bytes;
}

uint64_t shm_arena_free_slabs(void* arena) {
  Arena* a = static_cast<Arena*>(arena);
  std::lock_guard<std::mutex> lock(a->mu);
  uint64_t n = 0;
  for (auto& bucket : a->free_slabs) n += bucket.second.size();
  return n;
}

uint64_t shm_arena_reuses(void* arena) {
  Arena* a = static_cast<Arena*>(arena);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->reuses;
}

int shm_send_fd(int sock_fd, int fd) {
  char payload = 'F';
  struct iovec iov;
  iov.iov_base = &payload;
  iov.iov_len = 1;
  char cbuf[CMSG_SPACE(sizeof(int))];
  std::memset(cbuf, 0, sizeof(cbuf));
  struct msghdr msg;
  std::memset(&msg, 0, sizeof(msg));
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  msg.msg_control = cbuf;
  msg.msg_controllen = sizeof(cbuf);
  struct cmsghdr* cm = CMSG_FIRSTHDR(&msg);
  cm->cmsg_level = SOL_SOCKET;
  cm->cmsg_type = SCM_RIGHTS;
  cm->cmsg_len = CMSG_LEN(sizeof(int));
  std::memcpy(CMSG_DATA(cm), &fd, sizeof(int));
  for (;;) {
    ssize_t n = ::sendmsg(sock_fd, &msg, MSG_NOSIGNAL);
    if (n < 0 && errno == EINTR) continue;
    return n == 1 ? 0 : -1;
  }
}

int shm_recv_fd(int sock_fd) {
  char payload = 0;
  struct iovec iov;
  iov.iov_base = &payload;
  iov.iov_len = 1;
  char cbuf[CMSG_SPACE(sizeof(int))];
  std::memset(cbuf, 0, sizeof(cbuf));
  struct msghdr msg;
  std::memset(&msg, 0, sizeof(msg));
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  msg.msg_control = cbuf;
  msg.msg_controllen = sizeof(cbuf);
  ssize_t n;
  for (;;) {
    n = ::recvmsg(sock_fd, &msg, MSG_CMSG_CLOEXEC);
    if (n < 0 && errno == EINTR) continue;
    break;
  }
  if (n != 1) return -1;
  for (struct cmsghdr* cm = CMSG_FIRSTHDR(&msg); cm != nullptr;
       cm = CMSG_NXTHDR(&msg, cm)) {
    if (cm->cmsg_level == SOL_SOCKET && cm->cmsg_type == SCM_RIGHTS &&
        cm->cmsg_len >= CMSG_LEN(sizeof(int))) {
      int fd;
      std::memcpy(&fd, CMSG_DATA(cm), sizeof(int));
      if (fd < 0) return -1;
      return fd;
    }
  }
  return -1;
}

}  // extern "C"
