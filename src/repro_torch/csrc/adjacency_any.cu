// adjacency_any (K5): out[i, t] = (adj[plane[i], t] & masks[i]) != 0 for the
// live (pattern, arc) pairs of one batched AC sweep, as int32 {0, 1}; with
// plane == nullptr every pair is on plane 0 (the one-arc form,
// rows [n_t, w] against one mask).
//
// Replaces the Pallas TPU kernel repro/kernels/domain_ac.py::adjacency_any,
// which repro's batched fixpoint vmaps over lanes and maps over arc slots.
// The device code, its design and its bound are in arc_any.cuh, shared with
// arc_any_sweep.cu (K4): both compute the same function of the same
// arguments, and each named plane is read once per launch.
#include "arc_any.cuh"

extern "C" int adjacency_any_launch(const void* adj, const void* plane, const void* masks,
                                    void* out, int n_planes, int n_t, int w, int n_pairs,
                                    int R, int S, int C, void* stream) {
  return arc_any::launch(adj, plane, masks, out, n_planes, n_t, w, n_pairs, R, S, C, stream);
}
