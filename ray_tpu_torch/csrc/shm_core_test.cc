// Native unit tests for the graftshm slab arena and SCM_RIGHTS fd
// passing. Plain asserts, no framework (same convention as the other
// csrc suites); `make test` runs this plus TSAN/ASAN builds — the
// concurrent acquire/recycle storm below is the arena's race test.

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include "shm_core.h"

namespace {

// The suites' scratch files go under $TMPDIR (else /tmp).
std::string TmpBase() {
  const char* t = std::getenv("TMPDIR");
  return (t != nullptr && *t != '\0') ? std::string(t) : std::string("/tmp");
}

std::string TempDir(const char* name) {
  std::string dir = TmpBase() + "/raytpu_torch_shm_test_" + name + "_" +
                    std::to_string(::getpid());
  std::string cmd = "rm -rf " + dir + " && mkdir -p " + dir;
  assert(std::system(cmd.c_str()) == 0);
  return dir;
}

bool FileExists(const std::string& path) {
  struct stat st;
  return ::stat(path.c_str(), &st) == 0;
}

void TestAcquireRecycleReuse() {
  std::string dir = TempDir("reuse");
  void* a = shm_arena_create(dir.c_str(), 1 << 20);
  char p1[512], p2[512], p3[512];
  int reused = -1;

  int fd1 = shm_arena_acquire(a, 4096, p1, sizeof p1, &reused);
  assert(fd1 >= 0 && reused == 0 && FileExists(p1));
  // The slab really has its pages: write through a mapping.
  void* m = ::mmap(nullptr, 4096, PROT_READ | PROT_WRITE, MAP_SHARED, fd1, 0);
  assert(m != MAP_FAILED);
  std::memset(m, 'x', 4096);
  ::munmap(m, 4096);
  ::close(fd1);

  // Recycle, then an exact-size acquire reuses the SAME file (warm).
  shm_arena_recycle(a, p1, 4096);
  assert(shm_arena_free_bytes(a) == 4096);
  assert(shm_arena_free_slabs(a) == 1);
  int fd2 = shm_arena_acquire(a, 4096, p2, sizeof p2, &reused);
  assert(fd2 >= 0 && reused == 1);
  assert(std::strcmp(p1, p2) == 0);
  assert(shm_arena_free_bytes(a) == 0);
  assert(shm_arena_reuses(a) == 1);
  ::close(fd2);

  // A different size never matches the bucket: fresh slab.
  shm_arena_recycle(a, p2, 4096);
  int fd3 = shm_arena_acquire(a, 8192, p3, sizeof p3, &reused);
  assert(fd3 >= 0 && reused == 0);
  assert(std::strcmp(p3, p2) != 0);
  ::close(fd3);

  shm_arena_destroy(a);
  // destroy unlinks everything still on the free list.
  assert(!FileExists(p2));
  std::printf("  acquire/recycle/reuse OK\n");
}

void TestStaleFreeListEntry() {
  // Something (a directory sweeper) unlinked a free-listed slab behind
  // the arena's back: acquire must skip the stale entry and hand out a
  // fresh slab instead of failing.
  std::string dir = TempDir("stale");
  void* a = shm_arena_create(dir.c_str(), 1 << 20);
  char p1[512], p2[512];
  int reused = -1;
  int fd1 = shm_arena_acquire(a, 4096, p1, sizeof p1, &reused);
  assert(fd1 >= 0);
  ::close(fd1);
  shm_arena_recycle(a, p1, 4096);
  assert(::unlink(p1) == 0);  // sweeper strikes
  int fd2 = shm_arena_acquire(a, 4096, p2, sizeof p2, &reused);
  assert(fd2 >= 0 && reused == 0);
  assert(std::strcmp(p1, p2) != 0);
  ::close(fd2);
  shm_arena_destroy(a);
  std::printf("  stale free-list entry OK\n");
}

void TestRetentionCap() {
  // Free-bytes beyond the cap are bounded: the first over-cap recycle
  // parks in the single holdover slot (kept warm for an exact-size
  // re-acquire), the next one displaces it — never two slabs past cap.
  std::string dir = TempDir("cap");
  void* a = shm_arena_create(dir.c_str(), 8192);  // cap: two 4 KiB slabs
  char paths[4][512];
  int reused;
  for (int i = 0; i < 4; i++) {
    int fd = shm_arena_acquire(a, 4096, paths[i], sizeof paths[i], &reused);
    assert(fd >= 0);
    ::close(fd);
  }
  shm_arena_recycle(a, paths[0], 4096);
  shm_arena_recycle(a, paths[1], 4096);
  assert(shm_arena_free_bytes(a) == 8192);
  shm_arena_recycle(a, paths[2], 4096);  // over cap -> holdover slot
  assert(shm_arena_free_bytes(a) == 8192);  // holdover is off-books
  assert(FileExists(paths[2]));
  shm_arena_recycle(a, paths[3], 4096);  // displaces the holdover
  assert(!FileExists(paths[2]));
  assert(FileExists(paths[0]) && FileExists(paths[1]) &&
         FileExists(paths[3]));
  // The holdover serves exact-size acquires warm, like a bucket entry:
  // pop the two bucketed slabs, then the holdover must come back reused.
  char q[512];
  for (int i = 0; i < 3; i++) {
    reused = -1;
    int fd = shm_arena_acquire(a, 4096, q, sizeof q, &reused);
    assert(fd >= 0 && reused == 1);
    ::close(fd);
  }
  assert(std::strcmp(q, paths[3]) == 0);  // holdover drained last
  reused = -1;
  int fd = shm_arena_acquire(a, 4096, q, sizeof q, &reused);
  assert(fd >= 0 && reused == 0);  // everything drained: fresh slab
  ::close(fd);
  shm_arena_destroy(a);
  std::printf("  retention cap OK\n");
}

void TestEnospcIsClean() {
  // posix_fallocate of an absurd size must come back as the clean -2
  // (no fd leaked, no file left behind), never a sparse file that would
  // SIGBUS the mapped client later.
  std::string dir = TempDir("enospc");
  void* a = shm_arena_create(dir.c_str(), 1 << 20);
  char p[512];
  int reused;
  int rc = shm_arena_acquire(a, 1ull << 50, p, sizeof p, &reused);
  assert(rc == -2);
  // Directory holds no leftover slab.
  std::string probe = dir + "/shmslab-1";
  assert(!FileExists(probe));
  // The arena still works for sane sizes afterwards.
  int fd = shm_arena_acquire(a, 4096, p, sizeof p, &reused);
  assert(fd >= 0);
  ::close(fd);
  shm_arena_destroy(a);
  std::printf("  ENOSPC clean OK\n");
}

void TestFdPassing() {
  // SCM_RIGHTS round-trip over a socketpair: the received fd reads the
  // same inode the sender allocated.
  int sv[2];
  assert(::socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  std::string dir = TempDir("fdpass");
  void* a = shm_arena_create(dir.c_str(), 1 << 20);
  char p[512];
  int reused;
  int slab_fd = shm_arena_acquire(a, 4096, p, sizeof p, &reused);
  assert(slab_fd >= 0);
  assert(::pwrite(slab_fd, "fd-pass-payload", 15, 0) == 15);

  std::thread sender([&] {
    assert(shm_send_fd(sv[0], slab_fd) == 0);
  });
  int got = shm_recv_fd(sv[1]);
  sender.join();
  assert(got >= 0 && got != slab_fd);
  char buf[16] = {0};
  assert(::pread(got, buf, 15, 0) == 15);
  assert(std::memcmp(buf, "fd-pass-payload", 15) == 0);
  // Same inode, two descriptors.
  struct stat st1, st2;
  assert(::fstat(slab_fd, &st1) == 0 && ::fstat(got, &st2) == 0);
  assert(st1.st_ino == st2.st_ino);
  ::close(got);
  ::close(slab_fd);
  ::close(sv[0]);
  ::close(sv[1]);
  shm_arena_destroy(a);
  std::printf("  fd passing OK\n");
}

void TestRecvOnClosedPeer() {
  // Peer death mid-handshake: recv must fail cleanly, not hang or
  // fabricate an fd.
  int sv[2];
  assert(::socketpair(AF_UNIX, SOCK_STREAM, 0, sv) == 0);
  ::close(sv[0]);
  assert(shm_recv_fd(sv[1]) == -1);
  ::close(sv[1]);
  std::printf("  recv-on-closed-peer OK\n");
}

void TestConcurrentAcquireRecycle() {
  // The TSAN target: several threads hammering acquire/recycle on the
  // same sizes. Every acquire must yield a usable fd; accounting must
  // come back consistent once everything is recycled.
  std::string dir = TempDir("storm");
  void* a = shm_arena_create(dir.c_str(), 1 << 22);
  auto worker = [&](int t) {
    char p[512];
    int reused;
    uint64_t size = 4096 * (1 + (t % 2));  // two bucket sizes
    for (int i = 0; i < 200; i++) {
      int fd = shm_arena_acquire(a, size, p, sizeof p, &reused);
      assert(fd >= 0);
      assert(::pwrite(fd, &t, sizeof t, 0) == (ssize_t)sizeof t);
      ::close(fd);
      shm_arena_recycle(a, p, size);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < 4; t++) ts.emplace_back(worker, t);
  for (auto& th : ts) th.join();
  // All slabs are back on the free list; none leaked.
  assert(shm_arena_free_slabs(a) >= 2);
  assert(shm_arena_free_bytes(a) <= (uint64_t)(1 << 22));
  shm_arena_destroy(a);
  std::printf("  concurrent acquire/recycle OK\n");
}

}  // namespace

int main() {
  TestAcquireRecycleReuse();
  TestStaleFreeListEntry();
  TestRetentionCap();
  TestEnospcIsClean();
  TestFdPassing();
  TestRecvOnClosedPeer();
  TestConcurrentAcquireRecycle();
  std::printf("shm_core_test: ALL OK\n");
  return 0;
}
