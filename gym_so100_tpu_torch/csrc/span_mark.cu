// Span marks: one empty one-thread kernel per stage name, launched on the
// stream when a stage opens or closes while a profiler records
// (gym_so100_tpu_torch/profiling.py, `annotate`).
//
// Replaces no TPU kernel.  The port runs its step on one stream, so every
// device op between two marks belongs to the span the earlier one names;
// the marks stand in the device trace beside the ops, on the profiler's
// clock, and a CUDA graph captures and replays them with the work around
// them, which a host range is not.  A mark does no work: its cost is one
// launch, about a microsecond of device time on an idle card.
//
// SPAN_MARKS lists the marks in the order of `profiling.SPANS` (index,
// name); the test of the tracing checks that the two lists agree.

#include <cuda_runtime.h>

#define SPAN_MARKS(X)  \
    X(0, none)         \
    X(1, smooth)       \
    X(2, collide)      \
    X(3, efc)          \
    X(4, solve)        \
    X(5, integrate)    \
    X(6, render)       \
    X(7, autoreset)    \
    X(8, done_sync)

#define SPAN_KERNEL(i, name) extern "C" __global__ void gst_span_##name() {}
SPAN_MARKS(SPAN_KERNEL)

typedef void (*Mark)();
#define SPAN_ENTRY(i, name) gst_span_##name,
static const Mark marks[] = {SPAN_MARKS(SPAN_ENTRY)};
static const int n_marks = (int)(sizeof(marks) / sizeof(marks[0]));

// Launches mark `span` on `stream`; returns cudaErrorInvalidValue for an
// index outside the table.
extern "C" int gst_span_mark(int span, void* stream)
{
    if (span < 0 || span >= n_marks) return (int)cudaErrorInvalidValue;
    const Mark mark = marks[span];
    mark<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
