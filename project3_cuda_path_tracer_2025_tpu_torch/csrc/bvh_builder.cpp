// Native BVH builder: the host-side hot spot for large meshes.
//
// Same algorithm family as the Python fallback (scene/bvh.py) and the
// reference builder (midpoint split on the longest centroid axis, leaf at
// <= leaf_size triangles, positional median split when the midpoint
// partition degenerates), implemented iteratively with an explicit work
// stack and SoA outputs, and using the reference's in-place swap partition
// ordering so triangle order matches it exactly.
//
// C ABI consumed via ctypes (native/bvh_native.py), which builds this file
// with the host C++ compiler at first use into build/native/<hash>/.
//
// Output arrays are caller-allocated with capacity 2*T nodes (a binary tree
// whose leaves hold >= 1 triangle has at most 2T-1 nodes).

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <vector>

namespace {

struct WorkItem {
  int begin;
  int end;
  int parent;     // node index to patch, -1 for root
  bool is_right;  // which child slot of the parent
};

}  // namespace

extern "C" int build_bvh(
    const float* verts,      // [T * 9] triangle vertices (v0 v1 v2) xyz
    const float* centroids,  // [T * 3]
    int num_tris,
    int leaf_size,
    float* out_aabb_min,  // [maxM * 3]
    float* out_aabb_max,  // [maxM * 3]
    int* out_left,        // [maxM]
    int* out_right,       // [maxM]
    int* out_start,       // [maxM]
    int* out_count,       // [maxM]
    int* out_tri_indices  // [T]
) {
  if (num_tris <= 0 || leaf_size <= 0) return 0;
  const int max_nodes = 2 * num_tris;

  std::vector<int> order(num_tris);
  for (int i = 0; i < num_tris; ++i) order[i] = i;

  int node_count = 0;
  std::vector<WorkItem> stack;
  stack.reserve(64);
  stack.push_back({0, num_tris, -1, false});

  while (!stack.empty()) {
    WorkItem item = stack.back();
    stack.pop_back();

    if (node_count >= max_nodes) return -1;  // capacity bug guard
    const int node = node_count++;

    // Node bounds over member triangle vertices.
    float bmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float bmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = item.begin; i < item.end; ++i) {
      const float* tv = verts + 9 * static_cast<int64_t>(order[i]);
      for (int v = 0; v < 3; ++v) {
        for (int a = 0; a < 3; ++a) {
          const float x = tv[3 * v + a];
          bmin[a] = std::min(bmin[a], x);
          bmax[a] = std::max(bmax[a], x);
        }
      }
    }
    for (int a = 0; a < 3; ++a) {
      out_aabb_min[3 * node + a] = bmin[a];
      out_aabb_max[3 * node + a] = bmax[a];
    }

    if (item.parent >= 0) {
      (item.is_right ? out_right : out_left)[item.parent] = node;
    }

    const int n = item.end - item.begin;
    if (n <= leaf_size) {
      out_left[node] = -1;
      out_right[node] = -1;
      out_start[node] = item.begin;
      out_count[node] = n;
      continue;
    }

    // Centroid bounds -> split axis (longest extent; keep the reference's
    // exact two-test selection quirk: z beats a winning y whenever z > x).
    float cmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float cmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = item.begin; i < item.end; ++i) {
      const float* c = centroids + 3 * static_cast<int64_t>(order[i]);
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    const float ex = cmax[0] - cmin[0];
    const float ey = cmax[1] - cmin[1];
    const float ez = cmax[2] - cmin[2];
    int axis = 0;
    if (ey > ex && ey > ez) axis = 1;
    if (ez > ex) axis = 2;

    const float split = 0.5f * (cmin[axis] + cmax[axis]);

    // In-place swap partition (matches the reference's ordering).
    int mid = item.begin;
    for (int i = item.begin; i < item.end; ++i) {
      if (centroids[3 * static_cast<int64_t>(order[i]) + axis] < split) {
        std::swap(order[i], order[mid]);
        ++mid;
      }
    }
    if (mid == item.begin || mid == item.end) {
      mid = (item.begin + item.end) / 2;  // positional median fallback
    }

    out_start[node] = -1;
    out_count[node] = 0;

    // Pre-order numbering: left child must be node+1, so push right first.
    stack.push_back({mid, item.end, node, true});
    stack.push_back({item.begin, mid, node, false});
  }

  for (int i = 0; i < num_tris; ++i) out_tri_indices[i] = order[i];
  return node_count;
}
