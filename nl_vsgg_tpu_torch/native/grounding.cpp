// Native host-side grounding engine: assign_labels_video + build_entry
// (the packing half) as one C call per video.
//
// The port's copy of nl_vsgg_tpu/native/grounding.cpp, built by
// nl_vsgg_tpu_torch/utils/native_io.py. The Python host path
// (nl_vsgg_tpu_torch/data/grounding.py, a vectorized rebuild of the
// reference's lib/assign_pseudo_label.py:49-141,894-909,1196-1384) spends
// its time in the interpreter and in small numpy calls; this engine does the
// same work in C++ and releases the GIL under ctypes, so prefetch worker
// threads scale on multi-core hosts. The Python path remains the semantic
// reference; a fuzz test pins byte-identical Entry output
// (tests/test_torch_data_engine.py).
//
// The one subtle dependency is CPython set-iteration order: the reference
// emits a detection's mapped AG classes in `list(set(ag_ids) & set(gt))`
// order (assign_pseudo_label.py:128). py_int_set below reproduces CPython's
// setobject.c semantics (open addressing, hash(int)=int, LINEAR_PROBES=9,
// PERTURB_SHIFT=5, growth x4 when fill*5 >= mask*3) for non-negative int
// keys, including the two-step `frozenset(generator)` -> `set(frozenset)`
// rebuild and the smaller-operand iteration rule of set_intersection.
// Fuzz-tested against the live interpreter.
//
// Build: compiled into one library with io.cpp (utils/native_io.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CPython int-set emulation (Objects/setobject.c, Python 3.10-3.13 layout)
// ---------------------------------------------------------------------------

constexpr int LINEAR_PROBES = 9;
constexpr int PERTURB_SHIFT = 5;
constexpr size_t MINSIZE = 8;

struct PyIntSet {
    // slot: used flag + key; hash(key) == key for the non-negative ints here
    std::vector<uint8_t> used_;
    std::vector<int64_t> key_;
    size_t mask = MINSIZE - 1;
    size_t fill = 0, used = 0;

    PyIntSet() : used_(MINSIZE, 0), key_(MINSIZE, 0) {}

    bool contains(int64_t key) const {
        size_t hash = (size_t)key;
        size_t perturb = hash;
        size_t i = hash & mask;
        while (true) {
            size_t e = i;
            long probes = (i + LINEAR_PROBES <= mask) ? LINEAR_PROBES : 0;
            do {
                if (!used_[e]) return false;
                if (key_[e] == key) return true;
                e++;
            } while (probes--);
            perturb >>= PERTURB_SHIFT;
            i = (i * 5 + 1 + perturb) & mask;
        }
    }

    // set_insert_clean: resize-time reinsertion (no equality checks)
    static void insert_clean(std::vector<uint8_t>& u, std::vector<int64_t>& k,
                             size_t mask, int64_t key) {
        size_t hash = (size_t)key;
        size_t perturb = hash;
        size_t i = hash & mask;
        while (true) {
            size_t e = i;
            if (!u[e]) goto found;
            if (i + LINEAR_PROBES <= mask) {
                for (int j = 0; j < LINEAR_PROBES; j++) {
                    e++;
                    if (!u[e]) goto found;
                }
            }
            perturb >>= PERTURB_SHIFT;
            i = (i * 5 + 1 + perturb) & mask;
            continue;
        found:
            u[e] = 1;
            k[e] = key;
            return;
        }
    }

    void resize(size_t minused) {
        size_t newsize = MINSIZE;
        while (newsize <= minused) newsize <<= 1;
        std::vector<uint8_t> u(newsize, 0);
        std::vector<int64_t> k(newsize, 0);
        for (size_t e = 0; e <= mask; e++)
            if (used_[e]) insert_clean(u, k, newsize - 1, key_[e]);
        used_.swap(u);
        key_.swap(k);
        mask = newsize - 1;
        fill = used;  // no dummies
    }

    void add(int64_t key) {
        size_t hash = (size_t)key;
        size_t perturb = hash;
        size_t i = hash & mask;
        while (true) {
            size_t e = i;
            long probes = (i + LINEAR_PROBES <= mask) ? LINEAR_PROBES : 0;
            do {
                if (!used_[e]) {
                    used_[e] = 1;
                    key_[e] = key;
                    fill++;
                    used++;
                    if (fill * 5 >= mask * 3)
                        resize(used > 50000 ? used * 2 : used * 4);
                    return;
                }
                if (key_[e] == key) return;  // already present
                e++;
            } while (probes--);
            perturb >>= PERTURB_SHIFT;
            i = (i * 5 + 1 + perturb) & mask;
        }
    }

    // iteration order = ascending table index
    void iterate(std::vector<int64_t>& out) const {
        out.clear();
        for (size_t e = 0; e <= mask; e++)
            if (used_[e]) out.push_back(key_[e]);
    }

    // set_merge(so, other) with `so` freshly created (set(other) of a set/
    // frozenset operand): one up-front resize, then either a verbatim table
    // copy (same mask) or insert_clean in the other's iteration order.
    void merge_from(const PyIntSet& other) {
        if (other.used == 0) return;
        if ((fill + other.used) * 5 >= mask * 3)
            resize((used + other.used) * 2);
        if (fill == 0 && mask == other.mask) {  // no dummies ever here
            used_ = other.used_;
            key_ = other.key_;
            fill = other.fill;
            used = other.used;
            return;
        }
        if (fill == 0) {
            for (size_t e = 0; e <= other.mask; e++)
                if (other.used_[e])
                    insert_clean(used_, key_, mask, other.key_[e]);
            fill = used = other.used;
            return;
        }
        for (size_t e = 0; e <= other.mask; e++)  // general (unused here)
            if (other.used_[e]) add(other.key_[e]);
    }
};

// tuple(set(a) & set(b_frozen)) where:
//   set(a)        is built by inserting `a` in order (set_add_entry),
//   b_frozen      = frozenset built by inserting `b` in order,
//   set(b_frozen) copies via set_merge (verbatim table / insert_clean),
// and set_intersection iterates the smaller operand (ties: the right one),
// inserting hits into a fresh result set. Emission = result iteration order.
void intersect_order(const int64_t* a, int na, const int64_t* b, int nb,
                     std::vector<int64_t>& out) {
    PyIntSet A;
    for (int i = 0; i < na; i++) A.add(a[i]);
    PyIntSet Bf;
    for (int i = 0; i < nb; i++) Bf.add(b[i]);
    PyIntSet B;
    B.merge_from(Bf);

    // so = A, other = B; if size(other) > size(so) swap; iterate `other`
    const PyIntSet *so = &A, *other = &B;
    if (other->used > so->used) { const PyIntSet* t = so; so = other; other = t; }
    PyIntSet result;
    for (size_t e = 0; e <= other->mask; e++)
        if (other->used_[e] && so->contains(other->key_[e]))
            result.add(other->key_[e]);
    result.iterate(out);
}

}  // namespace

extern "C" {

// Test hook: emission order of `tuple(set(a) & set(b))` per CPython
// semantics. Returns the count written to out (caller sizes out >= min(na,nb)).
int pyset_intersect_order(const int64_t* a, int na, const int64_t* b, int nb,
                          int64_t* out) {
    std::vector<int64_t> v;
    intersect_order(a, na, b, nb, v);
    for (size_t i = 0; i < v.size(); i++) out[i] = v[i];
    return (int)v.size();
}

// ---------------------------------------------------------------------------
// ground_pack: assign_labels_video + build_entry packing for ONE video.
//
// Inputs are the padded per-frame tables from the native npy reader:
//   dets        (F, D, 6) float32 [class, conf, x1, y1, x2, y2]
//   det_counts  (F,)      int64   valid rows per frame
//   feats       (F, feat_stride, feat_dim) float32 RoI features
//   feat_counts (F,)      int64
// GT pack (train; G may be 0 at eval):
//   gt_cls      (G,)  int32 AG class per GT row, concatenated per frame
//   gt_off      (F+1,) int64 frame offsets into gt rows
//   gt_att/sp/con (G, 3/6/17) float32 multi-hot relationship rows
// Taxonomy:
//   person_lut  (lut_size,) uint8; oi2ag (n_oi, max_fan) int32 + counts
// Outputs are caller-zeroed bucket arrays (BB boxes / BR rels) matching the
// Entry fields; out_counts = [n_boxes_total, n_rels_total, n_rels_kept]
// (pre-truncation totals for the TruncationCounter).
// Returns 0 = ok, 1 = no relations (Entry is None), -1 = bad arguments.
int ground_pack(
    int F, int D, const float* dets, const int64_t* det_counts,
    const float* feats, int feat_stride, const int64_t* feat_counts,
    int feat_dim,
    const int32_t* gt_cls, const int64_t* gt_off,
    const float* gt_att, const float* gt_sp, const float* gt_con,
    const uint8_t* person_lut, int lut_size,
    const int32_t* oi2ag, const int32_t* oi2ag_cnt, int n_oi, int max_fan,
    int is_train, int pseudo_way,
    int BB, int BR,
    float* boxes, int32_t* box_frame, uint8_t* box_mask,
    int32_t* labels, float* scores, float* dist, float* out_feats,
    int32_t* pair_idx, int32_t* im_idx, uint8_t* rel_mask,
    float* att, float* sp, float* con,
    int64_t* out_counts) {
    if (F < 0 || D < 0 || BB <= 0 || BR <= 0 || feat_dim <= 0) return -1;

    int64_t n_boxes = 0, n_rels = 0, n_kept = 0;
    std::vector<int64_t> order;
    std::vector<int64_t> ag_buf, gt_buf;

    auto emit_box = [&](int frame, const float* rect, float conf,
                        int64_t label, const float* feat_row) -> int64_t {
        int64_t row = n_boxes++;
        if (row >= BB) return row;  // counted, not stored (truncation)
        std::memcpy(boxes + row * 4, rect, 4 * sizeof(float));
        box_frame[row] = frame;
        box_mask[row] = 1;
        labels[row] = (int32_t)label;
        scores[row] = conf;
        // create_dis (assign_pseudo_label.py:934-938): conf at label-1,
        // (1-conf)/35 elsewhere, 36 no-background columns
        float rest = (1.0f - conf) / 35.0f;
        float* drow = dist + row * 36;
        for (int c = 0; c < 36; c++) drow[c] = rest;
        int64_t idx = label - 1;
        if (idx >= 0 && idx < 36) drow[idx] = conf;
        if (feat_row != nullptr)
            std::memcpy(out_feats + row * feat_dim, feat_row,
                        feat_dim * sizeof(float));
        return row;
    };

    auto emit_rel = [&](int64_t person_row, int64_t obj_row, int frame,
                        const float* a3, const float* s6, const float* c17) {
        int64_t r = n_rels++;
        bool ok = r < BR && person_row < BB && obj_row < BB;
        if (!ok) return;  // pad_entry clamp semantics: counted as dropped
        n_kept++;
        pair_idx[r * 2] = (int32_t)person_row;
        pair_idx[r * 2 + 1] = (int32_t)obj_row;
        im_idx[r] = frame;
        rel_mask[r] = 1;
        if (a3) std::memcpy(att + r * 3, a3, 3 * sizeof(float));
        if (s6) std::memcpy(sp + r * 6, s6, 6 * sizeof(float));
        if (c17) std::memcpy(con + r * 17, c17, 17 * sizeof(float));
    };

    for (int f = 0; f < F; f++) {
        int64_t nd = det_counts[f];
        if (nd <= 0) continue;
        const float* drows = dets + (int64_t)f * D * 6;
        int64_t nfeat = feat_counts ? feat_counts[f] : nd;
        const float* frows = feats + (int64_t)f * feat_stride * feat_dim;

        // person: max-conf detection whose (1594->1593 folded) class is in
        // the person LUT; ties keep the first (np.argmax)
        int64_t person_idx = -1;
        float best = 0.0f;
        for (int64_t i = 0; i < nd; i++) {
            int64_t c = (int64_t)drows[i * 6];
            if (c == 1594) c = 1593;
            bool is_person = c >= 0 && c < lut_size && person_lut[c];
            if (is_person && (person_idx < 0 || drows[i * 6 + 1] > best)) {
                person_idx = i;
                best = drows[i * 6 + 1];
            }
        }
        if (person_idx < 0) {
            if (pseudo_way == 0) continue;  // frame skipped (no person)
            person_idx = 0;  // pseudo_way!=0: det 0 stands in as the person
        }

        int64_t person_row = emit_box(
            f, drows + person_idx * 6 + 2, drows[person_idx * 6 + 1], 1,
            person_idx < nfeat ? frows + person_idx * feat_dim : nullptr);

        int64_t g0 = gt_off ? gt_off[f] : 0;
        int64_t g1 = gt_off ? gt_off[f + 1] : 0;

        if (is_train) {
            gt_buf.clear();
            for (int64_t g = g0; g < g1; g++) gt_buf.push_back(gt_cls[g]);
        }

        for (int64_t i = 0; i < nd; i++) {
            if (i == person_idx) continue;
            int64_t c = (int64_t)drows[i * 6];
            if (c == 1594) c = 1593;
            if (c >= 0 && c < lut_size && person_lut[c]) continue;  // ~is_person
            if (c < 0 || c >= n_oi || oi2ag_cnt[c] <= 0) continue;
            ag_buf.clear();
            for (int32_t k = 0; k < oi2ag_cnt[c]; k++)
                ag_buf.push_back(oi2ag[c * max_fan + k]);
            const std::vector<int64_t>* emit;
            if (is_train) {
                intersect_order(ag_buf.data(), (int)ag_buf.size(),
                                gt_buf.data(), (int)gt_buf.size(), order);
                emit = &order;
            } else {
                emit = &ag_buf;
            }
            for (int64_t cls : *emit) {
                int64_t obj_row = emit_box(
                    f, drows + i * 6 + 2, drows[i * 6 + 1], cls,
                    i < nfeat ? frows + i * feat_dim : nullptr);
                if (is_train) {
                    // first GT row of this class in the frame (:1269-1291)
                    for (int64_t g = g0; g < g1; g++) {
                        if (gt_cls[g] == (int32_t)cls) {
                            emit_rel(person_row, obj_row, f,
                                     gt_att + g * 3, gt_sp + g * 6,
                                     gt_con + g * 17);
                            break;
                        }
                    }
                } else {
                    emit_rel(person_row, obj_row, f, nullptr, nullptr, nullptr);
                }
            }
        }
    }

    out_counts[0] = n_boxes;
    out_counts[1] = n_rels;
    out_counts[2] = n_kept;
    return n_rels == 0 ? 1 : 0;
}

}  // extern "C"
