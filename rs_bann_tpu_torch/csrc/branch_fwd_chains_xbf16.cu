// K7's forward-only instantiations on X stored in bf16 (--x-bf16): the
// bf16-X twins of csrc/branch_fwd_chains.cu, in a source of their own so
// that they compile beside it. The kernel: csrc/vg_chains.cuh, and for the
// deep shapes csrc/dense_deep.cuh's run_kernel, each on a bf16 X tile.
#include "vg_chains.cuh"

namespace rsbann {
namespace vg {

const void* vg_chains_fwd_kernel_xbf16(int km, bool deep, int act, int cc) {
    return chains_kernel<false, true>(km, deep, act, cc);
}

}  // namespace vg

namespace ddeep {

const void* run_fwd_kernel_xbf16(int km) { return run_kernel_for<false, true>(km); }

}  // namespace ddeep
}  // namespace rsbann
