// graftshm: slab arena + fd passing for the store-owned shared-memory
// object plane (csrc/shm_core.cc). See shm_core.cc for the design
// notes; store_server.cc drives the arena from its OP_CREATE/OP_SEAL
// handlers, and shm_core_test.cc exercises it standalone.

#ifndef RAY_TPU_SHM_CORE_H_
#define RAY_TPU_SHM_CORE_H_

#include <cstdint>

extern "C" {

// Arena of tmpfs-backed slab files ("shmslab-<seq>") under `dir`.
// `max_free_bytes` caps how many recycled-slab bytes are retained for
// reuse; beyond it, at most ONE further slab (the most recently
// recycled) is parked in a holdover slot and any slab it displaces is
// unlinked — a put/free loop on an object bigger than the whole cap
// still reuses warm pages.
void* shm_arena_create(const char* dir, uint64_t max_free_bytes);
void shm_arena_destroy(void* arena);

// Acquire a slab of exactly `size` bytes. Returns an O_RDWR fd (>= 0)
// and writes the slab path into out_path; *reused_out is 1 when the
// slab came from the free list (its pages are warm — the whole point).
// Negative returns: -2 no space (clean ENOSPC via fallocate — the
// caller falls back to a path whose admission can evict/spill), -3 io
// error.
int shm_arena_acquire(void* arena, uint64_t size, char* out_path,
                      int path_cap, int* reused_out);

// Return a slab to the free list (exact-size bucket); over the
// retained-bytes cap it takes the single holdover slot (displaced
// holdover is unlinked).
void shm_arena_recycle(void* arena, const char* path, uint64_t size);

// Stats (for tests and leak checks).
uint64_t shm_arena_free_bytes(void* arena);
uint64_t shm_arena_free_slabs(void* arena);
uint64_t shm_arena_reuses(void* arena);

// SCM_RIGHTS helpers: pass `fd` over the connected unix socket
// `sock_fd` alongside a 1-byte payload. shm_send_fd returns 0/-1;
// shm_recv_fd returns the received fd (>= 0) or -1.
int shm_send_fd(int sock_fd, int fd);
int shm_recv_fd(int sock_fd);

}  // extern "C"

#endif  // RAY_TPU_SHM_CORE_H_
