// The CSV drain's row renderer: cluster_log.csv and job_log.csv rows.
//
// Host code (no CUDA): Python's csv module spends about a microsecond a
// field, and a long multi-DC run emits millions of rows.  The rows come
// out byte for byte as sim/io.py's Python renderer writes them (the same
// printf formats, "\r\n" line ends), at fwrite speed.
//
// C ABI, loaded with ctypes by utils/native.py, which builds this file
// with g++ -O2 -shared -fPIC on first use.  Rows arrive as packed float32
// in the engine's column order (sim/step.py CLUSTER_COLS / JOB_COLS; a run
// with signal timelines appends SIGNAL_CLUSTER_COLS to the cluster rows); the
// entity names come once as a '\n'-joined blob, indexed per row.  Each
// call appends to the file at `path` and returns the rows written, or -1
// with errno set when the file cannot be opened, written or closed.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

std::vector<std::string> split_names(const char* blob) {
  std::vector<std::string> out;
  const char* p = blob;
  while (p && *p) {
    const char* nl = strchr(p, '\n');
    if (!nl) {
      out.emplace_back(p);
      break;
    }
    out.emplace_back(p, nl - p);
    p = nl + 1;
  }
  return out;
}

// close `f`; -1 (errno kept) if a write or the close failed
int64_t finish(FILE* f, int64_t written) {
  int err = ferror(f) ? (errno ? errno : EIO) : 0;
  if (fclose(f) != 0 && !err) err = errno ? errno : EIO;
  if (err) {
    errno = err;
    return -1;
  }
  return written;
}

}  // namespace

extern "C" {

// rows: [n_ticks, n_dc, n_cols] float32 in CLUSTER_COLS order; n_cols is
// 14, or 16 for a run with signal timelines (price_usd_kwh and
// carbon_g_kwh after energy_kJ, "%.4f" and "%.2f" as sim/io.py writes them).
int64_t write_cluster_rows(const char* path, const float* rows,
                           int64_t n_ticks, int64_t n_dc,
                           const char* dc_names_blob, int64_t n_cols) {
  auto names = split_names(dc_names_blob);
  if ((int64_t)names.size() < n_dc || (n_cols != 14 && n_cols != 16)) {
    errno = EINVAL;
    return -1;
  }
  errno = 0;
  FILE* f = fopen(path, "a");
  if (!f) return -1;
  int64_t written = 0;
  for (int64_t t = 0; t < n_ticks; ++t) {
    for (int64_t d = 0; d < n_dc; ++d) {
      const float* c = rows + (t * n_dc + d) * n_cols;
      // time_s,dc,freq,busy,free,run_total,run_inf,run_train,q_inf,q_train,
      // util_inst,util_avg,acc_job_unit,power_W,energy_kJ
      fprintf(f, "%.3f,%s,%.2f,%d,%d,%d,%d,%d,%d,%d,%.4f,%.4f,%.4f,%.2f,%.4f",
              c[0], names[d].c_str(), c[1], (int)c[2], (int)c[3], (int)c[4],
              (int)c[5], (int)c[6], (int)c[7], (int)c[8], c[9], c[10], c[11],
              c[12], c[13]);
      if (n_cols == 16) fprintf(f, ",%.4f,%.2f", c[14], c[15]);
      fputs("\r\n", f);
      ++written;
    }
  }
  return finish(f, written);
}

// rows: [n, 15] float32 in JOB_COLS order.
int64_t write_job_rows(const char* path, const float* rows, int64_t n,
                       const char* ingress_names_blob,
                       const char* dc_names_blob) {
  auto ing = split_names(ingress_names_blob);
  auto dcs = split_names(dc_names_blob);
  for (int64_t i = 0; i < n; ++i) {
    const float* c = rows + i * 15;
    int g = (int)c[1], d = (int)c[4];
    if (g < 0 || g >= (int)ing.size() || d < 0 || d >= (int)dcs.size()) {
      errno = EINVAL;
      return -1;
    }
  }
  errno = 0;
  FILE* f = fopen(path, "a");
  if (!f) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const float* c = rows + i * 15;
    const char* jtype = ((int)c[2] == 0) ? "inference" : "training";
    // jid,ingress,type,size,dc,f_used,n_gpus,net_lat_s,start_s,finish_s,
    // latency_s,preempt_count,T_pred,P_pred,E_pred
    fprintf(f, "%d,%s,%s,%.4f,%s,%.3f,%d,%.4f,%.6f,%.6f,%.6f,%d,%.6f,%.2f,%.2f\r\n",
            (int)c[0], ing[(int)c[1]].c_str(), jtype, c[3],
            dcs[(int)c[4]].c_str(), c[5], (int)c[6], c[7], c[8], c[9], c[10],
            (int)c[11], c[12], c[13], c[14]);
  }
  return finish(f, n);
}

}  // extern "C"
