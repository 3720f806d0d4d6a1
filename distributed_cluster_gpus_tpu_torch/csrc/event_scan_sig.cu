// B1, the event scan, with a workload's price and carbon signal timelines
// (workload/signals.py): csrc/event_scan.cu's instances with the signal
// sites compiled in (`kSig`; the head note there lists them), float clock.
// A translation unit of its own, so the signal instances build beside the
// others, in parallel, and the signal-free builds compile as they did.
// Entry points: event_scan_launch_sig and event_scan_smem_bytes_sig
// (kernels/event_scan.py).
#define DCG_SIGNALS 1
#include "event_scan.cu"
