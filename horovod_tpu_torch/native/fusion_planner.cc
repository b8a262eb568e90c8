// Fusion planner — native greedy bucketing for large parameter trees.
//
// Host-side equivalent of the reference's native fusion machinery
// (horovod/common/controller.cc:686-809 FuseResponses +
// fusion_buffer_manager.cc): given per-leaf (elem_count, dtype_code,
// itemsize), assign each leaf to a fusion bucket of <= threshold bytes,
// grouping same-dtype leaves in order. Pure index computation — the
// data movement happens elsewhere — but for 100k-leaf trees (large LLM
// param sets re-planned per signature) the native pass keeps plan time
// off the Python profile.
//
// C ABI: hvt_plan_fusion(n, elem_counts[], dtype_codes[], itemsizes[],
//                        threshold_bytes, bucket_ids_out[]) -> n_buckets

#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

int64_t hvt_plan_fusion(int64_t n, const int64_t* elem_counts,
                        const int32_t* dtype_codes,
                        const int32_t* itemsizes,
                        int64_t threshold_bytes,
                        int32_t* bucket_ids_out) {
  // Per-dtype running bucket: {dtype -> (bucket id, bytes used)}.
  struct Open { int32_t id; int64_t used; };
  std::unordered_map<int32_t, Open> open;
  int32_t next_bucket = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t bytes = elem_counts[i] * (int64_t)itemsizes[i];
    auto it = open.find(dtype_codes[i]);
    if (it == open.end()) {
      open[dtype_codes[i]] = {next_bucket, bytes};
      bucket_ids_out[i] = next_bucket++;
      continue;
    }
    Open& o = it->second;
    if (o.used > 0 && o.used + bytes > threshold_bytes) {
      o.id = next_bucket++;
      o.used = 0;
    }
    o.used += bytes;
    bucket_ids_out[i] = o.id;
  }
  return next_bucket;
}

}  // extern "C"
