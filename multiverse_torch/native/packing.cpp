// Host-side batch packing: first-seen-order index remapping.
//
// The per-batch scene-feature table is rebuilt every step with an
// old-row -> new-row remap in first-seen order (the behavior of
// reference: code/pred_utils.py:680-704, reimplemented in
// the JAX package's data/dataset.py).  The Python dict loop costs
// O(batch * T) interpreter dispatches per training step on the host
// thread that feeds the TPU; this does it in one pass of native code.
//
// Built by multiverse_torch.native (g++ -O3 -shared) and bound with
// ctypes; everything falls back to the Python implementation when the
// toolchain is unavailable.

#include <cstdint>

extern "C" {

// ids:       [count] input row ids (non-negative)
// out:       [count] remapped ids (first-seen order, starting at 0)
// seen:      [max_id + 1] scratch, must be pre-filled with -1
// table:     [capacity] receives the old id for each new id
// capacity:  maximum number of unique ids
// returns the number of unique ids, or -1 on capacity overflow
int64_t remap_first_seen(const int32_t* ids, int64_t count,
                         int32_t* out, int32_t* seen,
                         int32_t* table, int64_t capacity) {
    int64_t n_unique = 0;
    for (int64_t i = 0; i < count; ++i) {
        const int32_t old_id = ids[i];
        int32_t new_id = seen[old_id];
        if (new_id < 0) {
            if (n_unique >= capacity) return -1;
            new_id = static_cast<int32_t>(n_unique);
            seen[old_id] = new_id;
            table[n_unique] = old_id;
            ++n_unique;
        }
        out[i] = new_id;
    }
    return n_unique;
}

// Gather uint8 rows: table[i] selects rows[table[i]] -> out[i].
// rows: [num_rows, row_bytes]; out: [n, row_bytes]
void gather_rows_u8(const uint8_t* rows, const int32_t* table,
                    int64_t n, int64_t row_bytes, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* src = rows + static_cast<int64_t>(table[i]) * row_bytes;
        uint8_t* dst = out + i * row_bytes;
        for (int64_t b = 0; b < row_bytes; ++b) dst[b] = src[b];
    }
}

}  // extern "C"
