// Phase markers for the device trace of a replayed CUDA graph.
//
// Replaces no TPU kernel: a replayed graph runs none of the host's profiler
// ranges, so `utils/tracing.py` `phase` launches one of these one-thread,
// empty kernels at a phase's start (END = 0) and end (END = 1) while the
// stream captures. Each is a node of the graph, and CUPTI names each
// instantiation apart (`trace_mark<3, 0>`), so every replay's trace shows
// where a phase began and ended on the clock of the kernels between them.
// It does no work and touches no memory: its cost is one launch of a node
// in the graph's chain.
//
// ID is the phase's index in `tracing.PHASES`; MARKS ids are instantiated.

#include <cuda_runtime.h>

#include <array>
#include <utility>

template <int ID, int END>
__global__ void trace_mark() {}

namespace {

constexpr int MARKS = 16;

template <int ID>
cudaError_t launch(int end, cudaStream_t stream) {
  if (end) {
    trace_mark<ID, 1><<<1, 1, 0, stream>>>();
  } else {
    trace_mark<ID, 0><<<1, 1, 0, stream>>>();
  }
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(int, cudaStream_t);

template <int... I>
std::array<Launch, sizeof...(I)> table(std::integer_sequence<int, I...>) {
  return {&launch<I>...};
}

}  // namespace

extern "C" {

// The number of marker ids instantiated.
int recbox_trace_mark_count() { return MARKS; }

// Launch trace_mark<id, end != 0> on ``stream``; 0, or the CUDA error of
// the launch (an id outside [0, MARKS) is cudaErrorInvalidValue).
int recbox_trace_mark(int id, int end, void* stream) {
  static const auto launches = table(std::make_integer_sequence<int, MARKS>{});
  if (id < 0 || id >= MARKS) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launches[id](end, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
