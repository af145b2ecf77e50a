"""BVH acceleration structure.

The reference delegates to the Rust `bvh` crate: parallel SAH build
(hittable.rs:34) and a front-to-back nearest_traverse_iterator
(hittable.rs:141).  rt_tpu splits the equivalent functionality into:

- a host-side **builder** producing flattened SoA node arrays with
  hit/miss ("threaded") links for stackless traversal — a fast C++
  binned-SAH implementation (rt_tpu/bvh/cpp) with a pure-NumPy fallback
  (rt_tpu/bvh/builder.py);
- an on-device **traversal**: a vectorized ``lax.while_loop`` over per-ray
  node cursors (rt_tpu/bvh/traverse.py).
"""

from rt_tpu.bvh.builder import build_bvh

__all__ = ["build_bvh"]
