// arc_any_sweep (K4): out[a, t] = (adj_flat[arc_row[a], t] & masks[a]) != 0
// for every arc a of one RI-DS arc-consistency sweep and every target node
// t, as int32 {0, 1}; an arc_row outside [0, n_planes) supports no node.
//
// Replaces the Pallas TPU kernel repro/kernels/domain_ac.py::arc_any_sweep,
// whose grid (arc, 256-row tile) fetched each arc's plane tile through the
// scalar-prefetched arc_row table.  The device code, its design and its
// bound are in arc_any.cuh, shared with adjacency_any.cu (K5): each named
// plane is read once per launch, however many arcs name it.
#include "arc_any.cuh"

extern "C" int arc_any_sweep_launch(const void* adj_flat, const void* arc_row,
                                    const void* masks, void* out, int n_planes, int n_t,
                                    int w, int n_arcs, int R, int S, int C, void* stream) {
  return arc_any::launch(adj_flat, arc_row, masks, out, n_planes, n_t, w, n_arcs, R, S, C,
                         stream);
}
