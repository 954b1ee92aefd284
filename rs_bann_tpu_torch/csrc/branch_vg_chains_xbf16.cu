// K7's value-and-gradient instantiations on X stored in bf16 (--x-bf16):
// the bf16-X twins of those in csrc/branch_vg_chains.cu, which holds the
// entry points (vg_chains_f32 and vg_chains_deep_f32, with x_bf16), in a
// source of their own so that the four K7 sources compile in parallel. The
// kernel:
// csrc/vg_chains.cuh, and for the deep shapes csrc/dense_deep.cuh's
// run_kernel (K8's deep entry launches it too), each on a bf16 X tile.
#include "vg_chains.cuh"

namespace rsbann {
namespace vg {

const void* vg_chains_grad_kernel_xbf16(int km, bool deep, int act, int cc) {
    return chains_kernel<true, true>(km, deep, act, cc);
}

}  // namespace vg

namespace ddeep {

const void* run_grad_kernel_xbf16(int km) { return run_kernel_for<true, true>(km); }

}  // namespace ddeep
}  // namespace rsbann
