// The greedy balanced-kNN loop (reference velocyto/neighbors.py:11-140,
// the plain and the group-constrained variant in one loop) on the host.
//
// A copy of vtpu_balance_knn of velocyto_tpu/native/vtpu.cpp:38-70 and
// of nothing else in that file: the port builds it on first use with the
// host C++ compiler (native/__init__.py::build_balance) and needs
// neither zlib nor the JAX package's prebuilt library.  The loop is
// sequential by nature: each node's choice depends on the in-degrees the
// nodes before it left.
//
// Nodes are visited in lsi order; each keeps its first k candidates m
// with m != itself, l[m] < maxl and (when constrained) the node's group;
// slot 0 holds the node itself when the loop met it; a node whose sight
// ran out self-fills its last slots with the distance of its first
// candidate.  dsi_new must come filled with -1, dist_new and l with 0.
//
// Unlike the JAX package's copy it checks every index before it uses
// one (each entry of lsi, each candidate the loop reads) and returns -1
// at the first outside [0, n), 0 when the loop ran to its end: the
// candidates past a row's k-th acceptance are never read, so this costs
// one compare a step where a check of the whole (n, sight) table would
// read it all once more.

#include <stdint.h>

extern "C" {

int64_t vtt_balance_knn(const int64_t* dsi, const double* dist,
                        const int64_t* lsi, const int64_t* constraint,
                        int64_t n, int64_t sight, int64_t maxl, int64_t k,
                        int return_distance,
                        int64_t* dsi_new, double* dist_new, int64_t* l) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t el = lsi[i];
        if (el < 0 || el >= n) return -1;
        const int64_t* row = dsi + el * sight;
        int64_t p = 0;
        int64_t j = 0;
        for (j = 0; j < sight; ++j) {
            if (p >= k) break;
            const int64_t m = row[j];
            if (m < 0 || m >= n) return -1;
            if (el == m) { dsi_new[el * (k + 1)] = el; continue; }
            if (constraint && constraint[el] != constraint[m]) continue;
            if (l[m] >= maxl) continue;
            dsi_new[el * (k + 1) + p + 1] = m;
            l[m] += 1;
            if (return_distance)
                dist_new[el * (k + 1) + p + 1] = dist[el * sight + j];
            ++p;
        }
        if (j == sight && p < k) j = sight - 1;  // loop ran to completion
        if (j == sight - 1 && p < k) {
            while (p < k) {
                dsi_new[el * (k + 1) + p + 1] = el;
                dist_new[el * (k + 1) + p + 1] = dist[el * sight];
                ++p;
            }
        }
    }
    return 0;
}

}  // extern "C"
