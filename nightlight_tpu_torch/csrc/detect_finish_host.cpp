// The host mirror of K8 (csrc/detect_finish.cu): phases 3-6 of one frame's
// star detection on the CPU with the kernel's arithmetic (detect_finish.cuh),
// the 32 lanes of a candidate's warp run one after the other, so that its
// output is the kernel's bit for bit. Built and run by
// tests/test_torch_detect_finish.py and chip_smoke.py:
//   g++ -x c++ -std=c++17 -O2 -ffp-contract=off -D__host__= -D__device__=
//       -D__forceinline__=inline -I csrc csrc/detect_finish_host.cpp -o mirror
//   mirror IN OUT
// IN: int32 k, radius, cap, has_keep; float32 location, scale, star_sig,
// star_in_out, dist2_limit; int32 cy[k], cx[k]; float32 value[k]; uint8
// keep[k] when has_keep (else every candidate survived phase 2); float32
// patch[k][4r+1][4r+1]; uint8 ok[k][4r+1][4r+1]. OUT: the frame's output row,
// float32[3 + 5 cap], as the kernel writes it.
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "detect_finish.cuh"

namespace detect_finish {

// the butterfly of 32 lane partials, as the warp's __shfl_xor_sync adds them
float butterfly(float (&v)[kLanes]) {
    for (int off = kLanes / 2; off > 0; off /= 2) {
        float next[kLanes];
        for (int l = 0; l < kLanes; ++l) next[l] = v[l] + v[l ^ off];
        for (int l = 0; l < kLanes; ++l) v[l] = next[l];
    }
    return v[0];
}

// phases 4 and 6 of one candidate: its kFields results
void candidate(const Params& p, const float* patch, const uint8_t* ok, int cy, int cx,
               float* res) {
    State st = com_start(cy, cx);
    for (int round = 0; round < kRounds && com_active(st); ++round) {
        float lanes[3][kLanes], sum[3];
        for (int l = 0; l < kLanes; ++l) {
            com_lane(p, patch, ok, st, l, sum);
            for (int q = 0; q < 3; ++q) lanes[q][l] = sum[q];
        }
        for (int q = 0; q < 3; ++q) sum[q] = butterfly(lanes[q]);
        com_update(p, cy, cx, st, sum);
    }
    float lanes[2][kLanes], sum[2];
    for (int l = 0; l < kLanes; ++l) {
        hfr_lane(p, patch, ok, st, l, sum);
        lanes[0][l] = sum[0];
        lanes[1][l] = sum[1];
    }
    sum[0] = butterfly(lanes[0]);
    sum[1] = butterfly(lanes[1]);
    const Hfr h = hfr_of(sum);
    float inner[kLanes];
    int inner_pixels = 0;
    for (int l = 0; l < kLanes; ++l) {
        int px;
        inner_lane(p, patch, ok, st, h.inner_limit, l, inner[l], px);
        inner_pixels += px;
    }
    const float inner_mass = butterfly(inner);
    res[kX] = st.px;
    res[kY] = st.py;
    res[kMass] = st.mass;
    res[kHfr] = h.hfr;
    res[kMass2] = h.mass2;
    res[kPlausible] = plausible(p, h, inner_mass, inner_pixels) ? 1.f : 0.f;
}

// the overlap filter's fixed point as the plain loop reaches it: alive
// starts as valid, and every round tests every pair
std::vector<uint8_t> overlap_filter(const std::vector<float>& x, const std::vector<float>& y,
                                    const std::vector<float>& m, const std::vector<uint8_t>& valid,
                                    float r2) {
    const int n = (int)x.size();
    std::vector<uint8_t> alive(valid), next(n);
    for (bool changed = true; changed;) {
        changed = false;
        for (int i = 0; i < n; ++i) {
            bool a = valid[i];
            for (int j = 0; a && j < n; ++j)
                if (j != i && valid[j] && alive[j] && dominates(x.data(), y.data(), m.data(), i, j, r2))
                    a = false;
            next[i] = a;
            changed |= next[i] != alive[i];
        }
        alive = next;
    }
    return alive;
}

void frame(const Params& p, int k, int cap, const int* cys, const int* cxs, const float* vals,
           const uint8_t* keep, const float* patch, const uint8_t* ok, float* out) {
    const long long area = (long long)(4 * p.radius + 1) * (4 * p.radius + 1);
    std::vector<int> orig;
    for (int g = 0; g < k; ++g)
        if (!keep || keep[g]) orig.push_back(g);
    const int n = (int)orig.size();
    std::vector<float> res((size_t)n * kFields);
    std::vector<float> x(n), y(n), m(n);
    for (int c = 0; c < n; ++c) {
        const int g = orig[c];
        candidate(p, patch + g * area, ok + g * area, cys[g], cxs[g], &res[(size_t)c * kFields]);
        x[c] = (float)cxs[g];
        y[c] = (float)cys[g];
        m[c] = vals[g];
    }
    const float r2 = (float)p.radius * (float)p.radius;
    std::vector<uint8_t> alive = overlap_filter(x, y, m, std::vector<uint8_t>(n, 1), r2);
    for (int c = 0; c < n; ++c) {
        x[c] = res[(size_t)c * kFields + kX];
        y[c] = res[(size_t)c * kFields + kY];
        m[c] = res[(size_t)c * kFields + kMass];
    }
    alive = overlap_filter(x, y, m, alive, r2);
    std::vector<unsigned long long> keys;
    for (int c = 0; c < n; ++c)
        if (alive[c] && res[(size_t)c * kFields + kPlausible] != 0.f)
            keys.push_back(descending_key(res[(size_t)c * kFields + kMass2], c));
    std::sort(keys.begin(), keys.end());
    const int num = (int)keys.size();
    float lanes[kLanes] = {};
    for (int j = 0; j < num; ++j) {
        const int c = (int)(keys[j] & 0xffffffffu);
        const float* r = &res[(size_t)c * kFields];
        const float star[kStarFields] = {r[kX], r[kY], vals[orig[c]], r[kMass2], r[kHfr]};
        for (int f = 0; f < kStarFields; ++f) out[kHead + f * cap + j] = star[f];
        lanes[j % kLanes] = lanes[j % kLanes] + r[kHfr];
    }
    out[0] = (float)num;
    out[1] = butterfly(lanes) / (float)(num > 1 ? num : 1);
    out[2] = (float)n;
}

}  // namespace detect_finish

template <class T>
static bool read(FILE* f, T* dst, size_t n) {
    return std::fread(dst, sizeof(T), n, f) == n;
}

int main(int argc, char** argv) {
    if (argc != 3) return 2;
    FILE* in = std::fopen(argv[1], "rb");
    if (!in) return 3;
    int head[4];
    float fl[5];
    if (!read(in, head, 4) || !read(in, fl, 5)) return 3;
    const int k = head[0], radius = head[1], cap = head[2], has_keep = head[3];
    detect_finish::Params p{radius, detect_finish::com_threshold(fl[0], fl[1], fl[2]), fl[0],
                            fl[3], fl[4], detect_finish::grid_disk_count(radius, fl[4])};
    const size_t area = (size_t)(4 * radius + 1) * (4 * radius + 1);
    std::vector<int> cys(k), cxs(k);
    std::vector<float> vals(k), patch(k * area);
    std::vector<uint8_t> keep(has_keep ? k : 0), ok(k * area);
    if (!read(in, cys.data(), k) || !read(in, cxs.data(), k) || !read(in, vals.data(), k) ||
        !read(in, keep.data(), keep.size()) || !read(in, patch.data(), patch.size()) ||
        !read(in, ok.data(), ok.size()))
        return 3;
    std::fclose(in);
    std::vector<float> out(detect_finish::kHead + detect_finish::kStarFields * (size_t)cap, 0.f);
    detect_finish::frame(p, k, cap, cys.data(), cxs.data(), vals.data(),
                         has_keep ? keep.data() : nullptr, patch.data(), ok.data(), out.data());
    FILE* o = std::fopen(argv[2], "wb");
    if (!o || std::fwrite(out.data(), 4, out.size(), o) != out.size()) return 4;
    std::fclose(o);
    return 0;
}
