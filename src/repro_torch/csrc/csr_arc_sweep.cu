// csr_arc_sweep: K8, the support test of one RI-DS arc-consistency sweep over
// CSR planes, for every arc of the sweep and every target node.
//
// Replaces the Pallas TPU kernel repro/kernels/domain_ac.py::csr_arc_sweep
// (body _csr_sweep_kernel).  The device code and its design are in
// csr_arc_sweep.cuh: the arcs grouped by plane, a bit-transposed mask table
// per group, and a block per (group, row tile) that reads the tile's bounds
// and entries once for all of the group's arcs.
#include "csr_arc_sweep.cuh"

// seg_start / seg_len [n_planes, n_t], indices [n_idx], arc_row [n_arcs],
// masks [n_arcs, w] and out [n_arcs, n_t] are device pointers of contiguous
// int32 tensors (masks holds the bits of uint32 words); table is a device
// buffer of table_words int32 words (csr_sweep::launch says how many).
// Launches two kernels on the stream and returns the first CUDA error (0 if
// none).
extern "C" int csr_arc_sweep_launch(const void* seg_start, const void* seg_len,
                                    const void* indices, const void* arc_row,
                                    const void* masks, void* out, void* table,
                                    long long table_words, int n_planes, int n_t, int n_idx,
                                    int w, int n_arcs, int deg_cap, void* stream) {
  return csr_sweep::launch(seg_start, seg_len, indices, arc_row, masks, out, table, table_words,
                           n_planes, n_t, n_idx, w, n_arcs, deg_cap, stream);
}
