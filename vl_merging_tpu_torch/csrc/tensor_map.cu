// Host side of hopper.cuh: TMA tensor maps (2-D, 3-D and 4-D bf16, 2-D int8).
// cuTensorMapEncodeTiled is a driver function; it is looked up in the
// driver library the CUDA runtime already loaded, so the kernels' library
// links against nothing new.
#include <dlfcn.h>

#include "hopper.cuh"

namespace vlm {
namespace hop {
namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, size_t elem_bytes,
                 const void* base, uint64_t rows, uint64_t cols, uint32_t box_rows,
                 uint32_t box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

bool make_tensor_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                     uint32_t box_rows, uint32_t box_cols) {
  return make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(__nv_bfloat16), base, rows,
                     cols, box_rows, box_cols);
}

bool make_tensor_map_i8(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                        uint32_t box_rows, uint32_t box_cols) {
  return make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, cols, box_rows,
                     box_cols);
}

bool make_tensor_map_3d(CUtensorMap* map, const void* base, const uint64_t (&dims)[3],
                        uint64_t row_bytes, uint64_t plane_bytes, const uint32_t (&box)[3]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t d[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t b[3] = {box[0], box[1], box[2]};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), d, strides, b,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool make_tensor_map_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                        const uint64_t (&strides)[3], const uint32_t (&box)[4]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, st, b, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop
}  // namespace vlm
