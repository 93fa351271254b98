// Marker kernels that bracket the frozen R3M backbone's work on a stream.
//
// A torch.profiler trace of the card (CUPTI's kernel records) names every
// kernel, in eager launches and inside CUDA graph replays alike, where no
// host range covers the replayed kernels. The span has a begin and an end
// kernel of one thread that does nothing; launched on the stream before and
// after the backbone's work, they land in the trace around it, so the
// backbone's time on the card is the end marker's start less the begin
// marker's end. The names are C names, kept as written.

#include <cuda_runtime.h>

extern "C" __global__ void tacorl_span_begin_encoder_backbone() {}
extern "C" __global__ void tacorl_span_end_encoder_backbone() {}

// Launch the begin marker on `stream`: 0 on success, else the launch's error.
extern "C" int backbone_span_begin(cudaStream_t stream) {
  tacorl_span_begin_encoder_backbone<<<1, 1, 0, stream>>>();
  return cudaGetLastError();
}

// Launch the end marker on `stream`: 0 on success, else the launch's error.
extern "C" int backbone_span_end(cudaStream_t stream) {
  tacorl_span_end_encoder_backbone<<<1, 1, 0, stream>>>();
  return cudaGetLastError();
}
