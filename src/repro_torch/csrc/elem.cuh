// Element conversions shared by the kernels that take f32 or bf16
// tensors: every kernel does its arithmetic in f32, widens on load and
// rounds once on store.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace elem {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* o) { *o = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* o) {
    *o = __float2bfloat16(x);
}

}  // namespace elem
