// B1, the event scan, for the float64 clock: csrc/event_scan.cu's kernel
// instances with a double clock (SimParams.time_dtype "float64"; the head
// note there says which state is double).  A translation unit of its own,
// so the double instances build beside the float ones, in parallel, and the
// float build compiles as it did.  Entry points: event_scan64_launch and
// event_scan64_smem_bytes (kernels/event_scan.py).
#define DCG_CLOCK64 1
#include "event_scan.cu"
