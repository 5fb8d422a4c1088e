// meshcore — native host-side mesh kernel for tpufem_torch (its own copy of
// tpufem/native/meshcore.cpp, the same code).
//
// The reference delegates all native mesh work to external binaries (Gmsh C++,
// Blender C/C++; SURVEY.md §2.2). The equivalents here are in-process: this
// library provides the host-side hot paths that feed arrays to the PyTorch
// compute path:
//   - msh2 ASCII parsing (nodes + tet/tri elements) without Python overhead
//   - boundary-face extraction from tet connectivity (hash-based, O(T))
//   - unique-edge enumeration (tet10 promotion, GNN edge lists)
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment). All
// functions are allocation-free from the caller's perspective: the caller
// passes output buffers sized by the corresponding *_count query, or the
// library fills a caller-provided capacity and returns the used size.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- boundary

// Key for an unordered triangle (sorted node triple packed into 96 bits).
struct TriKey {
    uint64_t lo;
    uint32_t hi;
    bool operator==(const TriKey& o) const { return lo == o.lo && hi == o.hi; }
};
struct TriKeyHash {
    size_t operator()(const TriKey& k) const {
        uint64_t h = k.lo * 0x9E3779B97F4A7C15ull ^ (uint64_t(k.hi) << 17);
        h ^= h >> 33; h *= 0xFF51AFD7ED558CCDull; h ^= h >> 33;
        return (size_t)h;
    }
};

static inline void sort3(int32_t& a, int32_t& b, int32_t& c) {
    if (a > b) { int32_t t = a; a = b; b = t; }
    if (b > c) { int32_t t = b; b = c; c = t; }
    if (a > b) { int32_t t = a; a = b; b = t; }
}

// Extract outward-oriented boundary faces of a positively-oriented tet mesh.
// tets: (T,4) int32. out_faces capacity: 4*T*3 worst case; returns face count.
int64_t boundary_faces(const int32_t* tets, int64_t T, int32_t* out_faces) {
    // per-tet outward faces of positive tet (a,b,c,d):
    // (a,c,b), (a,b,d), (b,c,d), (a,d,c)
    static const int F[4][3] = {{0, 2, 1}, {0, 1, 3}, {1, 2, 3}, {0, 3, 2}};
    std::unordered_map<TriKey, int64_t, TriKeyHash> seen;  // key -> oriented face idx or -1 (dup)
    std::vector<int32_t> oriented;
    oriented.reserve(T * 3);
    seen.reserve((size_t)T * 2);

    for (int64_t t = 0; t < T; ++t) {
        const int32_t* tet = tets + 4 * t;
        for (int f = 0; f < 4; ++f) {
            int32_t n0 = tet[F[f][0]], n1 = tet[F[f][1]], n2 = tet[F[f][2]];
            int32_t a = n0, b = n1, c = n2;
            sort3(a, b, c);
            TriKey key{(uint64_t)(uint32_t)a | ((uint64_t)(uint32_t)b << 32),
                       (uint32_t)c};
            auto it = seen.find(key);
            if (it == seen.end()) {
                int64_t idx = (int64_t)oriented.size();
                oriented.push_back(n0);
                oriented.push_back(n1);
                oriented.push_back(n2);
                seen.emplace(key, idx);
            } else {
                it->second = -1;  // interior face (seen twice)
            }
        }
    }
    int64_t count = 0;
    for (auto& kv : seen) {
        if (kv.second >= 0) {
            std::memcpy(out_faces + 3 * count, oriented.data() + kv.second,
                        3 * sizeof(int32_t));
            ++count;
        }
    }
    return count;
}

// ------------------------------------------------------------------- edges

// Unique undirected edges of tet connectivity. out_edges capacity: 6*T*2.
// Returns edge count. Edges are (min,max) pairs, sorted lexicographically.
int64_t unique_edges(const int32_t* tets, int64_t T, int32_t* out_edges) {
    static const int E[6][2] = {{0, 1}, {1, 2}, {2, 0}, {0, 3}, {1, 3}, {2, 3}};
    std::unordered_map<uint64_t, int32_t> seen;
    seen.reserve((size_t)T * 4);
    std::vector<uint64_t> keys;
    keys.reserve((size_t)T * 4);
    for (int64_t t = 0; t < T; ++t) {
        const int32_t* tet = tets + 4 * t;
        for (int e = 0; e < 6; ++e) {
            int32_t a = tet[E[e][0]], b = tet[E[e][1]];
            if (a > b) { int32_t x = a; a = b; b = x; }
            uint64_t key = (uint64_t)(uint32_t)a << 32 | (uint32_t)b;
            if (seen.emplace(key, 1).second) keys.push_back(key);
        }
    }
    std::sort(keys.begin(), keys.end());
    int64_t count = (int64_t)keys.size();
    for (int64_t i = 0; i < count; ++i) {
        out_edges[2 * i] = (int32_t)(keys[i] >> 32);
        out_edges[2 * i + 1] = (int32_t)(keys[i] & 0xFFFFFFFFu);
    }
    return count;
}

// Unique undirected surface edges from triangle faces (GNN edge list).
// out capacity 3*F*2; returns count; pairs (min,max) sorted.
int64_t unique_tri_edges(const int32_t* faces, int64_t F, int32_t* out_edges) {
    static const int E[3][2] = {{0, 1}, {1, 2}, {2, 0}};
    std::unordered_map<uint64_t, int32_t> seen;
    seen.reserve((size_t)F * 2);
    std::vector<uint64_t> keys;
    keys.reserve((size_t)F * 2);
    for (int64_t f = 0; f < F; ++f) {
        const int32_t* tri = faces + 3 * f;
        for (int e = 0; e < 3; ++e) {
            int32_t a = tri[E[e][0]], b = tri[E[e][1]];
            if (a > b) { int32_t x = a; a = b; b = x; }
            uint64_t key = (uint64_t)(uint32_t)a << 32 | (uint32_t)b;
            if (seen.emplace(key, 1).second) keys.push_back(key);
        }
    }
    std::sort(keys.begin(), keys.end());
    int64_t count = (int64_t)keys.size();
    for (int64_t i = 0; i < count; ++i) {
        out_edges[2 * i] = (int32_t)(keys[i] >> 32);
        out_edges[2 * i + 1] = (int32_t)(keys[i] & 0xFFFFFFFFu);
    }
    return count;
}

// ------------------------------------------------------------------ msh2

// Parse the $Nodes/$Elements sections of MSH v2 ASCII text.
// Two-phase: *_counts fills (n_nodes, n_tris, n_tets); parse fills buffers:
//   node_ids (n_nodes) int64, node_xyz (n_nodes*3) double,
//   tris (n_tris*3) int64, tets (n_tets*4) int64   (corner nodes, 1-based ids)
// Returns 0 on success, negative on malformed input.
static const char* find_section(const char* text, const char* name) {
    const char* p = strstr(text, name);
    if (!p) return nullptr;
    p = strchr(p, '\n');
    return p ? p + 1 : nullptr;
}

int msh2_counts(const char* text, int64_t* n_nodes, int64_t* n_tris, int64_t* n_tets) {
    const char* p = find_section(text, "$Nodes");
    if (!p) return -1;
    char* end;
    *n_nodes = strtoll(p, &end, 10);
    const char* q = find_section(text, "$Elements");
    if (!q) return -2;
    int64_t n_elem = strtoll(q, (char**)&end, 10);
    p = end;
    int64_t tris = 0, tets = 0;
    for (int64_t i = 0; i < n_elem; ++i) {
        // line: id type ntags tags... nodes...
        strtoll(p, &end, 10);
        p = end;
        long type = strtol(p, &end, 10);
        p = end;
        long ntags = strtol(p, &end, 10);
        p = end;
        long nn;
        switch (type) {
            case 2: nn = 3; tris++; break;
            case 9: nn = 6; tris++; break;
            case 4: nn = 4; tets++; break;
            case 11: nn = 10; tets++; break;
            case 1: nn = 2; break;   // line
            case 8: nn = 3; break;   // quadratic line
            case 15: nn = 1; break;  // point
            case 3: nn = 4; break;   // quad
            default: return -3;
        }
        for (long k = 0; k < ntags + nn; ++k) {
            strtoll(p, &end, 10);
            p = end;
        }
    }
    *n_tris = tris;
    *n_tets = tets;
    return 0;
}

int msh2_parse(const char* text, int64_t* node_ids, double* node_xyz,
               int64_t* tris, int64_t* tets) {
    const char* p = find_section(text, "$Nodes");
    if (!p) return -1;
    char* end;
    int64_t n_nodes = strtoll(p, &end, 10);
    p = end;
    for (int64_t i = 0; i < n_nodes; ++i) {
        node_ids[i] = strtoll(p, &end, 10);
        p = end;
        for (int k = 0; k < 3; ++k) {
            node_xyz[3 * i + k] = strtod(p, &end);
            p = end;
        }
    }
    const char* q = find_section(text, "$Elements");
    if (!q) return -2;
    int64_t n_elem = strtoll(q, (char**)&end, 10);
    p = end;
    int64_t it = 0, iv = 0;
    for (int64_t i = 0; i < n_elem; ++i) {
        strtoll(p, &end, 10);
        p = end;
        long type = strtol(p, &end, 10);
        p = end;
        long ntags = strtol(p, &end, 10);
        p = end;
        for (long k = 0; k < ntags; ++k) { strtoll(p, &end, 10); p = end; }
        long nn, keep;
        int64_t* dst;
        switch (type) {
            case 2: nn = 3; keep = 3; dst = tris + 3 * it++; break;
            case 9: nn = 6; keep = 3; dst = tris + 3 * it++; break;
            case 4: nn = 4; keep = 4; dst = tets + 4 * iv++; break;
            case 11: nn = 10; keep = 4; dst = tets + 4 * iv++; break;
            case 1: nn = 2; keep = 0; dst = nullptr; break;
            case 8: nn = 3; keep = 0; dst = nullptr; break;
            case 15: nn = 1; keep = 0; dst = nullptr; break;
            case 3: nn = 4; keep = 0; dst = nullptr; break;
            default: return -3;
        }
        for (long k = 0; k < nn; ++k) {
            int64_t v = strtoll(p, &end, 10);
            p = end;
            if (dst && k < keep) dst[k] = v;
        }
    }
    return 0;
}

}  // extern "C"
