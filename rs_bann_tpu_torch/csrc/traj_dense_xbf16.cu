// K6's kernels on X stored in bf16 (--x-bf16): the bf16-X instantiations
// of csrc/traj_dense.cuh, in a source of their own so that they compile
// beside csrc/traj_dense.cu, which holds the plans and the entry points
// (traj_dense_f32, traj_dense_deep_f32, with x_bf16).
#include "traj_dense.cuh"

namespace rsbann {
namespace traj {

const void* kernel_xbf16(int km, bool deep, int act, int cc) {
    return kernel_for<true>(km, deep, act, cc);
}

const void* deep_kernel_xbf16(int km) { return deep_kernel_for<true>(km); }

}  // namespace traj
}  // namespace rsbann
