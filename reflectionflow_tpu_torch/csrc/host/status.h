// Return codes and failures shared by the host codecs of this directory
// (each built into its own library by `ops/kernel_build.py::build_host_all`,
// which hashes this header into every library's key).
//
// A decoder's C entry point returns RF_OK, RF_NEED_BUFFER (the size is in
// `dims`; call again with a buffer), RF_REFUSED (what PIL refuses too: the
// message ends ", as PIL refuses it") or RF_CORRUPT; its body throws `Fail`
// through `corrupt` / `refused` and the entry point copies the message out
// with `write_err`.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>

namespace {

constexpr int RF_OK = 0;
constexpr int RF_CORRUPT = -1;
constexpr int RF_REFUSED = -3;
constexpr int RF_NEED_BUFFER = 1;

struct Fail {
  int code;
  std::string msg;
  bool short_input = false;  // the data ran out (a stream decoder would wait for more)
};

[[noreturn]] inline void corrupt(const std::string& msg) { throw Fail{RF_CORRUPT, msg}; }
// What PIL cannot open either: refused for good, not queued.
[[noreturn]] inline void refused(const std::string& msg) { throw Fail{RF_REFUSED, msg + ", as PIL refuses it"}; }

inline void write_err(const std::string& msg, char* err, int64_t cap) {
  if (!err || cap <= 0) return;
  size_t n = msg.size() < static_cast<size_t>(cap - 1) ? msg.size() : static_cast<size_t>(cap - 1);
  memcpy(err, msg.data(), n);
  err[n] = 0;
}

}  // namespace
