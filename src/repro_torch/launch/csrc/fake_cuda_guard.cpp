// A no-op CUDA device guard for torch builds without CUDA.
//
// A dry-run trace (launch/graph_cost.py) runs the card's program on fake
// CUDA tensors: nothing is allocated and nothing runs. A torch built
// without CUDA registers no CUDA device guard, so the first indexing of a
// fake CUDA tensor fails in the guard lookup. Loading this library
// registers the no-op guard that FakeTensorMode itself means to install
// (torch._C._ensureCUDADeviceGuardSet): it reports one device and one
// default stream and does nothing. A torch built with CUDA never loads it.
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {
c10::impl::NoOpDeviceGuardImpl<c10::DeviceType::CUDA> no_op_cuda_guard;

struct Register {
  Register() {
    if (!c10::impl::hasDeviceGuardImpl(c10::DeviceType::CUDA)) {
      c10::impl::device_guard_impl_registry[static_cast<size_t>(
          c10::DeviceType::CUDA)].store(&no_op_cuda_guard);
    }
  }
} register_at_load;
}  // namespace

extern "C" int fake_cuda_guard_registered() {
  return c10::impl::hasDeviceGuardImpl(c10::DeviceType::CUDA) ? 1 : 0;
}
