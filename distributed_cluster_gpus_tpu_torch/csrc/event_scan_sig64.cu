// B1, the event scan, with a workload's price and carbon signal timelines,
// double clock: csrc/event_scan.cu built with DCG_SIGNALS and DCG_CLOCK64
// (see csrc/event_scan_sig.cu and csrc/event_scan64.cu).  Entry points:
// event_scan_launch_sig64 and event_scan_smem_bytes_sig64
// (kernels/event_scan.py).
#define DCG_SIGNALS 1
#define DCG_CLOCK64 1
#include "event_scan.cu"
