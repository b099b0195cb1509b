// Guard-band device allocator for the kernels' selftest
// (shifu_tpu_torch/ops/selftest.py --guard).  No kernel: host code that
// PyTorch's CUDAPluggableAllocator calls in place of its caching
// allocator, so that every tensor of the process, the wrappers' outputs
// included, is a cudaMalloc of its own with kGuard bytes before and after
// it.
//
// The whole block, the tensor's own bytes included, is filled with 0xFF
// when it is allocated.  A float read past either end of a tensor, or
// from an element no kernel wrote, then reads NaN (0xFF..FF in f32, bf16
// and f16), which the selftest's comparison with the plain version
// catches; an id read there reads -1.  A write past either end changes a
// guard byte, which guard_free finds when the tensor is freed: it waits
// for the tensor's stream, copies both guards to the host and counts the
// blocks whose guards changed.  This is memcheck's --padding and
// initcheck's uninitialised-read check done with the runtime API alone,
// for a machine where compute-sanitizer cannot attach to the device.
#include <cuda_runtime.h>
#include <stdint.h>
#include <sys/types.h>

#include <mutex>
#include <vector>

namespace {

constexpr size_t kGuard = 4096;
constexpr unsigned char kFill = 0xFF;

std::mutex mu;
long long n_allocs = 0;
long long n_violations = 0;
// the first violation: the tensor's bytes and the offset of its first
// changed guard byte from the tensor's start (negative: before it); a
// guard that could not be read back is reported at offset kUnread
long long first_size = -1;
long long first_offset = 0;
constexpr long long kUnread = -(1LL << 62);

void record(long long size, long long offset) {
  std::lock_guard<std::mutex> g(mu);
  if (n_violations++ == 0) {
    first_size = size;
    first_offset = offset;
  }
}

}  // namespace

extern "C" {

void* guard_malloc(ssize_t size, int device, cudaStream_t stream) {
  if (cudaSetDevice(device) != cudaSuccess) return nullptr;
  char* base = nullptr;
  const size_t total = (size_t)size + 2 * kGuard;
  if (cudaMalloc(&base, total) != cudaSuccess) return nullptr;
  if (cudaMemsetAsync(base, kFill, total, stream) != cudaSuccess) {
    cudaFree(base);
    return nullptr;
  }
  std::lock_guard<std::mutex> g(mu);
  ++n_allocs;
  return base + kGuard;
}

void guard_free(void* ptr, ssize_t size, int device, cudaStream_t stream) {
  if (ptr == nullptr) return;
  cudaSetDevice(device);
  char* base = static_cast<char*>(ptr) - kGuard;
  std::vector<unsigned char> host(2 * kGuard);
  const bool read =
      cudaStreamSynchronize(stream) == cudaSuccess &&
      cudaMemcpy(host.data(), base, kGuard, cudaMemcpyDeviceToHost) ==
          cudaSuccess &&
      cudaMemcpy(host.data() + kGuard, static_cast<char*>(ptr) + size,
                 kGuard, cudaMemcpyDeviceToHost) == cudaSuccess;
  if (!read) {
    record(size, kUnread);
  } else {
    for (size_t i = 0; i < 2 * kGuard; ++i) {
      if (host[i] != kFill) {
        record(size, i < kGuard ? (long long)i - (long long)kGuard
                                : (long long)size + (long long)(i - kGuard));
        break;
      }
    }
  }
  cudaFree(base);
}

long long guard_allocations() {
  std::lock_guard<std::mutex> g(mu);
  return n_allocs;
}

long long guard_violations() {
  std::lock_guard<std::mutex> g(mu);
  return n_violations;
}

// the first violation's tensor size and guard offset (see `record`)
long long guard_first_size() {
  std::lock_guard<std::mutex> g(mu);
  return first_size;
}

long long guard_first_offset() {
  std::lock_guard<std::mutex> g(mu);
  return first_offset;
}

}  // extern "C"
