// Wire protocol between the C++ NerfManager shim and the JAX runtime server
// (romap_tpu/runtime/server.py). Length-prefixed little-endian frames over a
// UNIX domain socket:
//   request:  u32 opcode | u32 payload_len | payload
//   reply:    u32 status (0 = ok, 1 = error-string payload) | u32 len | payload
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace monerf {

enum class Op : uint32_t {
  kInit = 1,
  kDatasetInit = 2,
  kNewFrame = 3,
  kCreateNerf = 4,
  kUpdateBbox = 5,
  kGetFrameIdx = 6,
  kWaitEnd = 7,
  kRenderTest = 8,
  kGetMesh = 9,
  kUpdatePoses = 10,
  kGetLosses = 11,
  kShutdown = 12,
  kPump = 13,
  kStart = 14,
  kUpdateVolume = 15,
};

// Growable little-endian message writer.
class Writer {
 public:
  void u8(uint8_t v) { push(&v, 1); }
  void u16(uint16_t v) { push(&v, 2); }
  void i32(int32_t v) { push(&v, 4); }
  void f32(float v) { push(&v, 4); }
  void str(const std::string& s) {
    u16(static_cast<uint16_t>(s.size()));
    push(s.data(), s.size());
  }
  void bytes(const void* p, size_t n) { push(p, n); }
  const std::vector<uint8_t>& data() const { return buf_; }

 private:
  void push(const void* p, size_t n) {
    const auto* b = static_cast<const uint8_t*>(p);
    buf_.insert(buf_.end(), b, b + n);
  }
  std::vector<uint8_t> buf_;
};

// Reader over a reply payload.
class Reader {
 public:
  explicit Reader(std::vector<uint8_t> data) : data_(std::move(data)) {}
  int32_t i32() { return take<int32_t>(); }
  float f32() { return take<float>(); }
  void bytes(void* out, size_t n) {
    if (off_ + n > data_.size()) throw std::runtime_error("ipc: short reply");
    std::memcpy(out, data_.data() + off_, n);
    off_ += n;
  }
  size_t remaining() const { return data_.size() - off_; }

 private:
  template <typename T>
  T take() {
    T v;
    bytes(&v, sizeof(T));
    return v;
  }
  std::vector<uint8_t> data_;
  size_t off_ = 0;
};

}  // namespace monerf
