// Launch helper shared by the csrc/*.cu kernels.
//
// No entry point sets the CUDA device: the caller makes the tensors' device
// current around the call (wgbs_tools_tpu_torch/_kernels.py::launch, with
// PyTorch's own device guard), so the caller's current device is never
// changed here.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace wgbs {

// One lock for every launch of this library: the shared-memory attribute
// belongs to the kernel, not to the calling thread, so two host threads
// (bam2pat's chromosome threads) that set it and launch at once could
// each launch against the other's, smaller, attribute.
inline std::mutex& launch_lock() {
    static std::mutex m;
    return m;
}

// Sets the kernel's dynamic shared memory on the current device (the
// attribute is per device; above 48 KB a launch needs it), launches the
// kernel on `stream`, and returns the launch's cudaError_t; under
// launch_lock(), so that no other thread changes the attribute between
// the two.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                  void* stream, Args... args) {
    std::lock_guard<std::mutex> hold(launch_lock());
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace wgbs
