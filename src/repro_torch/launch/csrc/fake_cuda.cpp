// A stand-in for the CUDA runtime pieces that tracing fake CUDA tensors
// touches, for a PyTorch built without CUDA (the dry-run's CPU machines).
// Loaded with LD_PRELOAD into a dry-run process only (launch/fake_cuda.py):
//   * a CUDA device guard: one device, cuda:0, whose streams and events do
//     nothing (Python's indexing, .to() and copies set a device guard);
//   * at::accelerator::getAccelerator() answers CUDA, and the CUDA hooks
//     report a primary context: autograd's engine takes the accelerator's
//     current stream for each gradient it adds up.
// Nothing here allocates or runs on a device; fake tensors never do.
#include <ATen/DeviceAccelerator.h>
#include <ATen/detail/CUDAHooksInterface.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {

using c10::Device;
using c10::DeviceType;
using c10::Stream;

const Device kDevice(DeviceType::CUDA, 0);

struct FakeCudaGuard final : c10::impl::DeviceGuardImplInterface {
  DeviceType type() const override { return DeviceType::CUDA; }
  Device exchangeDevice(Device) const override { return kDevice; }
  Device getDevice() const override { return kDevice; }
  void setDevice(Device) const override {}
  void uncheckedSetDevice(Device) const noexcept override {}
  Stream getStream(Device) const override {
    return Stream(Stream::DEFAULT, kDevice);
  }
  Stream exchangeStream(Stream) const override {
    return Stream(Stream::DEFAULT, kDevice);
  }
  c10::DeviceIndex deviceCount() const noexcept override { return 1; }
  void destroyEvent(void*, const c10::DeviceIndex) const noexcept override {}
  void record(void**, const Stream&, const c10::DeviceIndex,
              const c10::EventFlag) const override {}
  void block(void*, const Stream&) const override {}
  bool queryEvent(void*) const override { return true; }
};

struct FakeCudaHooks final : at::CUDAHooksInterface {
  bool hasPrimaryContext(c10::DeviceIndex) const override { return true; }
};

}  // namespace

C10_REGISTER_GUARD_IMPL(CUDA, FakeCudaGuard);

namespace at::accelerator {
std::optional<c10::DeviceType> getAccelerator(bool) {
  return c10::DeviceType::CUDA;
}
}  // namespace at::accelerator

namespace at::detail {
const CUDAHooksInterface& getCUDAHooks() {
  static FakeCudaHooks hooks;
  return hooks;
}
}  // namespace at::detail
