// chadrt — native host runtime of chad_tsdf_tpu_torch (a copy of the JAX
// package's native/chadrt.cpp, built by native.py into _build/).
//
// The reference implements its DAG hash-consing with gtl parallel hash sets
// whose functors dereference the node pools (reference:
// include/chad/detail/levels.hpp:8-144).  The TPU build keeps the quantized
// per-voxel math on device and performs the pointer-ish hash-consing on the
// host; this library is the fast path for that (the pure-numpy/python
// implementation in core/dag.py remains as the portable fallback and as the
// differential-testing oracle).
//
// Layout is identical to the reference and to core/dag.py:
//   node level : flat uint32 pool, node = [8-bit child mask,
//                addr x popcount(mask)], address = offset, 0 = null
//   leaf level : flat uint64 pool, 1-based addresses
//
// It also holds the port's own host helper of TSDFMap.insert:
// distinct_block_keys, the density estimate that picks a scan's accumulate
// backend (core/map.py _dispatch_config), one pass and a hash set in place
// of numpy's eight array passes and sort.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 chadrt.cpp -o libchadrt.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <unordered_map>

namespace {

struct NodeKey {
    uint32_t kids[8];
    bool operator==(const NodeKey& o) const {
        return std::memcmp(kids, o.kids, sizeof(kids)) == 0;
    }
};

struct NodeKeyHash {
    size_t operator()(const NodeKey& k) const {
        // FNV-1a over the 8 children
        uint64_t h = 1469598103934665603ull;
        for (uint32_t v : k.kids) {
            h ^= v;
            h *= 1099511628211ull;
        }
        return static_cast<size_t>(h);
    }
};

struct NodeLevel {
    std::vector<uint32_t> raw;
    std::unordered_map<NodeKey, uint32_t, NodeKeyHash> index;
    uint64_t uniques = 0, dupes = 0;
    NodeLevel() { raw.push_back(0); }  // address 0 reserved null
};

struct LeafLevel {
    std::vector<uint64_t> raw;
    std::unordered_map<uint64_t, uint32_t> index;
    uint64_t uniques = 0, dupes = 0;
    LeafLevel() { raw.push_back(0); }  // address 0 reserved
};

// numpy's float32 -> int64 cast on x86-64 (cvttss2si): NaN, infinities
// and values outside int64 give INT64_MIN.
inline int64_t to_int64(float v) {
    if (!(v >= -9.223372e18f && v < 9.223372e18f)) return INT64_MIN;
    return static_cast<int64_t>(v);
}

}  // namespace

extern "C" {

// The number of distinct keys (bx << 42) ^ (by << 21) ^ bz, with b =
// int64(floor(p / block)) in float32 as numpy computes it, over the rows 0,
// stride, 2 * stride, ... < n of the (n, 3) float32 points: the count
// np.unique gives in core/map.py _dispatch_config.  An open-addressing hash
// set at most half full.
uint64_t distinct_block_keys(const float* pts, uint64_t n, uint64_t stride,
                             float block) {
    if (n == 0 || stride == 0) return 0;
    const uint64_t m = (n + stride - 1) / stride;
    int bits = 4;
    while ((uint64_t{1} << bits) < 2 * m) ++bits;
    const uint64_t mask = (uint64_t{1} << bits) - 1;
    std::vector<uint64_t> table(mask + 1);
    std::vector<uint8_t> used(mask + 1, 0);
    uint64_t count = 0;
    for (uint64_t i = 0; i < n; i += stride) {
        const float* p = pts + 3 * i;
        const uint64_t bx = static_cast<uint64_t>(to_int64(std::floor(p[0] / block)));
        const uint64_t by = static_cast<uint64_t>(to_int64(std::floor(p[1] / block)));
        const uint64_t bz = static_cast<uint64_t>(to_int64(std::floor(p[2] / block)));
        const uint64_t key = (bx << 42) ^ (by << 21) ^ bz;
        uint64_t h = (key * 0x9E3779B97F4A7C15ull) >> (64 - bits);
        while (used[h] && table[h] != key) h = (h + 1) & mask;
        if (!used[h]) {
            used[h] = 1;
            table[h] = key;
            ++count;
        }
    }
    return count;
}

// ---------------- node level ----------------
void* nodelevel_new() { return new NodeLevel(); }
void nodelevel_free(void* p) { delete static_cast<NodeLevel*>(p); }

// children: m x 8 uint32 (0 = absent child); writes m canonical addresses.
void nodelevel_add_batch(void* p, const uint32_t* children, uint64_t m,
                         uint32_t* out_addrs) {
    auto* lv = static_cast<NodeLevel*>(p);
    lv->raw.reserve(lv->raw.size() + 9 * m);
    for (uint64_t i = 0; i < m; i++) {
        NodeKey key;
        std::memcpy(key.kids, children + 8 * i, sizeof(key.kids));
        auto [it, inserted] = lv->index.try_emplace(
            key, static_cast<uint32_t>(lv->raw.size()));
        if (inserted) {
            uint32_t mask = 0, packed[8];
            int n = 0;
            for (int c = 0; c < 8; c++) {
                if (key.kids[c]) {
                    mask |= 1u << c;
                    packed[n++] = key.kids[c];
                }
            }
            lv->raw.push_back(mask);
            lv->raw.insert(lv->raw.end(), packed, packed + n);
            lv->uniques++;
        } else {
            lv->dupes++;
        }
        out_addrs[i] = it->second;
    }
}

uint64_t nodelevel_size(void* p) {
    return static_cast<NodeLevel*>(p)->raw.size();
}
void nodelevel_copy_raw(void* p, uint32_t* out) {
    auto* lv = static_cast<NodeLevel*>(p);
    std::memcpy(out, lv->raw.data(), lv->raw.size() * sizeof(uint32_t));
}
uint64_t nodelevel_uniques(void* p) {
    return static_cast<NodeLevel*>(p)->uniques;
}
uint64_t nodelevel_dupes(void* p) {
    return static_cast<NodeLevel*>(p)->dupes;
}
void nodelevel_set_counters(void* p, uint64_t uniques, uint64_t dupes) {
    auto* lv = static_cast<NodeLevel*>(p);
    lv->uniques = uniques;
    lv->dupes = dupes;
}

// rebuild pool + index from a serialized pool (checkpoint load)
void nodelevel_restore(void* p, const uint32_t* raw, uint64_t n) {
    auto* lv = static_cast<NodeLevel*>(p);
    lv->raw.assign(raw, raw + n);
    lv->index.clear();
    lv->uniques = 0;
    lv->dupes = 0;
    uint64_t addr = 1;
    while (addr < n) {
        uint32_t mask = raw[addr] & 0xFF;
        NodeKey key{};
        int k = 0;
        for (int c = 0; c < 8; c++) {
            key.kids[c] = (mask & (1u << c)) ? raw[addr + 1 + k++] : 0;
        }
        lv->index.emplace(key, static_cast<uint32_t>(addr));
        addr += 1 + __builtin_popcount(mask);
        lv->uniques++;
    }
}

// vectorized child lookup: for m node addrs, write m x 8 child addrs
void nodelevel_child_addrs(void* p, const uint32_t* addrs, uint64_t m,
                           uint32_t* out) {
    auto* lv = static_cast<NodeLevel*>(p);
    const uint32_t* raw = lv->raw.data();
    for (uint64_t i = 0; i < m; i++) {
        uint32_t addr = addrs[i];
        uint32_t mask = raw[addr] & 0xFF;
        int k = 0;
        for (int c = 0; c < 8; c++) {
            out[8 * i + c] = (mask & (1u << c)) ? raw[addr + 1 + k++] : 0;
        }
    }
}

// ---------------- leaf-cluster level ----------------
void* lclevel_new() { return new LeafLevel(); }
void lclevel_free(void* p) { delete static_cast<LeafLevel*>(p); }

void lclevel_add_batch(void* p, const uint64_t* words, uint64_t m,
                       uint32_t* out_addrs) {
    auto* lv = static_cast<LeafLevel*>(p);
    lv->raw.reserve(lv->raw.size() + m);
    for (uint64_t i = 0; i < m; i++) {
        auto [it, inserted] = lv->index.try_emplace(
            words[i], static_cast<uint32_t>(lv->raw.size()));
        if (inserted) {
            lv->raw.push_back(words[i]);
            lv->uniques++;
        } else {
            lv->dupes++;
        }
        out_addrs[i] = it->second;
    }
}

uint64_t lclevel_size(void* p) {
    return static_cast<LeafLevel*>(p)->raw.size();
}
void lclevel_copy_raw(void* p, uint64_t* out) {
    auto* lv = static_cast<LeafLevel*>(p);
    std::memcpy(out, lv->raw.data(), lv->raw.size() * sizeof(uint64_t));
}
void lclevel_get(void* p, const uint32_t* addrs, uint64_t m, uint64_t* out) {
    auto* lv = static_cast<LeafLevel*>(p);
    for (uint64_t i = 0; i < m; i++) out[i] = lv->raw[addrs[i]];
}
uint64_t lclevel_uniques(void* p) {
    return static_cast<LeafLevel*>(p)->uniques;
}
uint64_t lclevel_dupes(void* p) {
    return static_cast<LeafLevel*>(p)->dupes;
}
void lclevel_set_counters(void* p, uint64_t uniques, uint64_t dupes) {
    auto* lv = static_cast<LeafLevel*>(p);
    lv->uniques = uniques;
    lv->dupes = dupes;
}
void lclevel_restore(void* p, const uint64_t* raw, uint64_t n) {
    auto* lv = static_cast<LeafLevel*>(p);
    lv->raw.assign(raw, raw + n);
    lv->index.clear();
    for (uint64_t i = 1; i < n; i++) {
        lv->index.emplace(raw[i], static_cast<uint32_t>(i));
    }
    lv->uniques = n > 0 ? n - 1 : 0;
    lv->dupes = 0;
}

}  // extern "C"
