// Blocking UNIX-socket client for the JAX runtime server. Thread-safe
// (single connection guarded by a mutex; the runtime serializes anyway).
#pragma once

#include <mutex>
#include <string>
#include <vector>

#include "monerf/ipc.h"

namespace monerf {

class RuntimeClient {
 public:
  explicit RuntimeClient(const std::string& socket_path);
  ~RuntimeClient();

  RuntimeClient(const RuntimeClient&) = delete;
  RuntimeClient& operator=(const RuntimeClient&) = delete;

  // Sends one request and returns the reply payload; throws on error status.
  Reader call(Op op, const Writer& w);

 private:
  void send_all(const void* p, size_t n);
  void recv_all(void* p, size_t n);

  int fd_ = -1;
  std::mutex mu_;
};

}  // namespace monerf
