// Native host-side I/O shim for the LiDAR engine.
//
// The reference's native layer (PCL / nanoflann C++) carries the
// performance-critical compute; in this design compute lives in
// XLA/Pallas kernels and the native layer's remaining job is fast
// host-side ingestion: zero-copy scan loading feeding the device
// pipeline (SURVEY.md §7 design stance). This shim provides
// mmap-backed file reads and a multi-threaded scan prefetcher,
// exposed over a C ABI for ctypes.
//
// Build: see native/Makefile (produces liblidar_io.so).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Returns the file size in bytes, or -1 on error.
int64_t tl_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

// Reads the whole file into the caller-provided buffer (mmap + memcpy,
// which outperforms stdio fread for the many-small-files KITTI layout).
// Returns bytes read, or -1 on error.
int64_t tl_read_file(const char* path, void* out, int64_t capacity) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  int64_t size = st.st_size;
  if (size > capacity) {
    close(fd);
    return -1;
  }
  void* mapped = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mapped == MAP_FAILED) {
    close(fd);
    return -1;
  }
  std::memcpy(out, mapped, size);
  munmap(mapped, size);
  close(fd);
  return size;
}

// ---------------------------------------------------------------------
// Asynchronous scan prefetcher: a worker pool reads files ahead of the
// consumer so device steps never wait on disk. The host pipeline pulls
// buffers in submission order (the analogue of the reference's DDS
// subscription queues, subscriber.hpp:72-77).

struct Prefetcher {
  struct Slot {
    std::string path;
    std::vector<uint8_t> data;
    int64_t size = -2;  // -2 = pending, -1 = error, >=0 = ready
  };

  std::vector<std::thread> workers;
  std::deque<size_t> work;  // indices into slots
  // deque, NOT vector: workers hold a Slot* across the unlocked read
  // (below), and submit() keeps appending — vector reallocation left a
  // dangling pointer, so the worker wrote size/data into freed memory:
  // the real slot stayed "pending" forever (consumer deadlock in
  // wait_size) and the heap corruption surfaced as segfaults in
  // unrelated allocations later in the process. std::deque guarantees
  // reference stability for push_back.
  std::deque<Slot> slots;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  explicit Prefetcher(int n_threads) {
    for (int i = 0; i < n_threads; i++) {
      workers.emplace_back([this] { this->worker(); });
    }
  }

  ~Prefetcher() {
    stop.store(true);
    cv.notify_all();
    for (auto& t : workers) t.join();
  }

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stop.load() || !work.empty(); });
        if (stop.load() && work.empty()) return;
        idx = work.front();
        work.pop_front();
      }
      Slot* slot;
      {
        std::lock_guard<std::mutex> lock(mu);
        slot = &slots[idx];
      }
      int64_t size = tl_file_size(slot->path.c_str());
      int64_t got = -1;
      if (size >= 0) {
        slot->data.resize(size);
        got = tl_read_file(slot->path.c_str(), slot->data.data(), size);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        slot->size = got;
      }
      cv.notify_all();
    }
  }

  int64_t submit(const char* path) {
    std::lock_guard<std::mutex> lock(mu);
    slots.push_back(Slot{path, {}, -2});
    work.push_back(slots.size() - 1);
    cv.notify_one();
    return static_cast<int64_t>(slots.size() - 1);
  }

  int64_t wait_size(int64_t handle) {
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [this, handle] { return slots[handle].size != -2; });
    return slots[handle].size;
  }

  int64_t take(int64_t handle, void* out, int64_t capacity) {
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [this, handle] { return slots[handle].size != -2; });
    Slot& slot = slots[handle];
    if (slot.size < 0 || slot.size > capacity) return -1;
    std::memcpy(out, slot.data.data(), slot.size);
    int64_t size = slot.size;
    slot.data.clear();
    slot.data.shrink_to_fit();
    return size;
  }
};

void* tl_prefetcher_create(int n_threads) {
  return new Prefetcher(n_threads > 0 ? n_threads : 4);
}

void tl_prefetcher_destroy(void* p) {
  delete static_cast<Prefetcher*>(p);
}

int64_t tl_prefetcher_submit(void* p, const char* path) {
  return static_cast<Prefetcher*>(p)->submit(path);
}

int64_t tl_prefetcher_wait_size(void* p, int64_t handle) {
  return static_cast<Prefetcher*>(p)->wait_size(handle);
}

int64_t tl_prefetcher_take(void* p, int64_t handle, void* out,
                           int64_t capacity) {
  return static_cast<Prefetcher*>(p)->take(handle, out, capacity);
}

}  // extern "C"
