// R3 merge bookkeeping of one pass: the port of repro/core/plan.py::merge_rows,
// a lax.scan over the r sub-bucket sizes of every active bucket (not a
// Pallas kernel in the reference).  One thread per active row walks its r
// counts in order, so a pass costs one launch instead of r eager steps.
//
// Bound: bytes — the (rows, r) int32 histogram read once and two (rows, r)
// byte tables written once; a few thousand rows, microseconds.
#include "common.cuh"

__global__ void merge_rows_kernel(const int* __restrict__ hist, int rows,
                                  int r, int local_threshold,
                                  int merge_threshold,
                                  uint8_t* __restrict__ gstart,
                                  uint8_t* __restrict__ gdone) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= rows) return;
  const long long row = static_cast<long long>(a) * r;
  int acc = merge_threshold;
  for (int v = 0; v < r; ++v) {
    const int s = hist[row + v];
    const bool big = s > local_threshold;
    const bool extend = (s == 0) || (!big && acc + s < merge_threshold);
    acc = extend ? acc + s : (big ? merge_threshold : s);
    gstart[row + v] = !extend;
    gdone[row + v] = !big;
  }
}

REPRO_ERROR_STRING

extern "C" int merge_rows_launch(const void* hist, int rows, int r,
                                 int local_threshold, int merge_threshold,
                                 void* gstart, void* gdone, void* stream) {
  if (rows < 1 || r < 1) return cudaErrorInvalidValue;
  const int threads = 128;
  merge_rows_kernel<<<(rows + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), rows, r, local_threshold,
      merge_threshold, static_cast<uint8_t*>(gstart),
      static_cast<uint8_t*>(gdone));
  return static_cast<int>(cudaGetLastError());
}
