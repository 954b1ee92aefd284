// K7's forward-only instantiations (y_pred alone: the folded transition's
// value passes, through forward_chains), in a source of their own so that
// they compile beside the value-and-gradient ones of
// csrc/branch_vg_chains.cu, which holds the entry points. The kernel:
// csrc/vg_chains.cuh, and for the deep shapes csrc/dense_deep.cuh's
// run_kernel (K8's forward-only launches there run it too).
#include "vg_chains.cuh"

namespace rsbann {
namespace vg {

const void* vg_chains_fwd_kernel(int km, bool deep, int act, int cc) {
    return chains_kernel<false, false>(km, deep, act, cc);
}

}  // namespace vg

namespace ddeep {

const void* run_fwd_kernel(int km) { return run_kernel_for<false, false>(km); }

}  // namespace ddeep
}  // namespace rsbann
