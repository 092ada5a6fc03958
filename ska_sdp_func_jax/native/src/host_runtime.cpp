// Native host runtime of the framework: visibility planning,
// binning and sorting on the ingest path.
//
// The device executes the jitted gridding graphs; everything that
// is host-side bookkeeping over raw visibility metadata lives here so it
// runs at memory bandwidth with OpenMP instead of through the Python/JAX
// dispatch layer.
//
// Reference equivalents:
//  - channel clamping: grid_data/sdp_gridder_clamp_channels.h:100-178
//  - uvw bounds:       grid_data/sdp_gridder_utils.cpp:682-720
//  - per-box counting: grid_data/sdp_grid_wstack_wtower.cpp:66-136
//  - bucket sort:      visibility/sdp_tiled_functions.cpp (GPU bucket
//    sort of visibilities into tile order)
//
// All functions use a plain C ABI for ctypes binding; arrays are caller
// allocated. Built with: g++ -O3 -fopenmp -shared -fPIC.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kC0 = 299792458.0;
constexpr double kIntGuard = 2147483645.0;

// Mirror of sdp_gridder_clamp_channels_inline (and the framework's
// _clamp_1d): clamp [start, end) so that min_u <= u0 + ch*du < max_u.
inline void clamp_1d(double u, double freq0_hz, double dfreq_hz,
                     double min_u, double max_u,
                     int64_t* start, int64_t* end)
{
    const double u0 = freq0_hz * u / kC0;
    const double du = dfreq_hz * u / kC0;
    const double eta =
        std::max(std::fabs(min_u - u0), std::fabs(max_u - u0)) / kIntGuard;
    if (du > eta)
    {
        *start = std::max(*start,
                          (int64_t)std::ceil((min_u - u0) / du));
        *end = std::min(*end, (int64_t)std::ceil((max_u - u0) / du));
    }
    else if (du < -eta)
    {
        *start = std::max(*start,
                          (int64_t)std::ceil((max_u - u0) / du));
        *end = std::min(*end, (int64_t)std::ceil((min_u - u0) / du));
    }
    else if (min_u > u0 || max_u <= u0)
    {
        *start = 0;
        *end = 0;
    }
    if (*end <= *start)
    {
        *start = 0;
        *end = 0;
    }
}

}  // namespace

extern "C" {

// Scaled (u,v,w) min/max over all rows and selected channels
// (sdp_gridder_uvw_bounds_all).
void sdp_host_uvw_bounds(const double* uvw, int64_t num_rows,
                        double freq0_hz, double dfreq_hz,
                        const int32_t* start_chs, const int32_t* end_chs,
                        double* uvw_min, double* uvw_max)
{
    for (int d = 0; d < 3; ++d)
    {
        uvw_min[d] = INFINITY;
        uvw_max[d] = -INFINITY;
    }
    for (int64_t r = 0; r < num_rows; ++r)
    {
        const int64_t s = start_chs[r], e = end_chs[r];
        if (s >= e) continue;
        for (int d = 0; d < 3; ++d)
        {
            const double c = uvw[3 * r + d];
            const double u0 = freq0_hz * c / kC0;
            const double du = dfreq_hz * c / kC0;
            const double a = u0 + (double)s * du;
            const double b = u0 + (double)(e - 1) * du;
            const double lo = c >= 0 ? a : b;
            const double hi = c >= 0 ? b : a;
            uvw_min[d] = std::min(uvw_min[d], lo);
            uvw_max[d] = std::max(uvw_max[d], hi);
        }
    }
}

// One-pass w-stacking task planner: for every (iw, iu, iv) box, count
// the selected visibilities and track the scaled-w bounds of the
// selection. Replaces the per-box clamp+count loop of the Python
// planner (and of sdp_grid_wstack_wtower.cpp:66-136) with a single
// OpenMP pass over rows.
//
// counts / wmin / wmax are [n_iw * n_iu * n_iv], C order (iw, iu, iv).
void sdp_host_plan_wstack(const double* uvw, int64_t num_rows,
                         double freq0_hz, double dfreq_hz,
                         int64_t num_chan,
                         double eff_sg_dist, double w_stack_dist,
                         int64_t min_iu, int64_t n_iu,
                         int64_t min_iv, int64_t n_iv,
                         int64_t min_iw, int64_t n_iw,
                         int64_t* counts, double* wmin, double* wmax)
{
    const int64_t n_boxes = n_iw * n_iu * n_iv;
    for (int64_t i = 0; i < n_boxes; ++i)
    {
        counts[i] = 0;
        wmin[i] = INFINITY;
        wmax[i] = -INFINITY;
    }

#ifdef _OPENMP
    const int num_threads = omp_get_max_threads();
#else
    const int num_threads = 1;
#endif
    std::vector<std::vector<int64_t>> t_counts(
        num_threads, std::vector<int64_t>(n_boxes, 0));
    std::vector<std::vector<double>> t_wmin(
        num_threads, std::vector<double>(n_boxes, INFINITY));
    std::vector<std::vector<double>> t_wmax(
        num_threads, std::vector<double>(n_boxes, -INFINITY));

#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < num_rows; ++r)
    {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
#else
        const int tid = 0;
#endif
        const double u = uvw[3 * r + 0];
        const double v = uvw[3 * r + 1];
        const double w = uvw[3 * r + 2];
        for (int64_t jw = 0; jw < n_iw; ++jw)
        {
            const double min_w =
                (double)(min_iw + jw) * w_stack_dist - w_stack_dist / 2;
            const double max_w = min_w + w_stack_dist;
            int64_t s_w = 0, e_w = num_chan;
            clamp_1d(w, freq0_hz, dfreq_hz, min_w, max_w, &s_w, &e_w);
            if (s_w >= e_w) continue;
            for (int64_t ju = 0; ju < n_iu; ++ju)
            {
                const double min_u =
                    (double)(min_iu + ju) * eff_sg_dist - eff_sg_dist / 2;
                const double max_u = min_u + eff_sg_dist;
                int64_t s_u = s_w, e_u = e_w;
                clamp_1d(u, freq0_hz, dfreq_hz, min_u, max_u, &s_u, &e_u);
                if (s_u >= e_u) continue;
                for (int64_t jv = 0; jv < n_iv; ++jv)
                {
                    const double min_v =
                        (double)(min_iv + jv) * eff_sg_dist
                        - eff_sg_dist / 2;
                    const double max_v = min_v + eff_sg_dist;
                    int64_t s = s_u, e = e_u;
                    clamp_1d(v, freq0_hz, dfreq_hz, min_v, max_v, &s, &e);
                    if (s >= e) continue;
                    const int64_t box = (jw * n_iu + ju) * n_iv + jv;
                    t_counts[tid][box] += e - s;
                    // Scaled-w bounds of the selection at the channel
                    // endpoints (monotonic in channel).
                    const double w0 = freq0_hz * w / kC0;
                    const double dw = dfreq_hz * w / kC0;
                    const double a = w0 + (double)s * dw;
                    const double b = w0 + (double)(e - 1) * dw;
                    const double lo = std::min(a, b);
                    const double hi = std::max(a, b);
                    if (lo < t_wmin[tid][box]) t_wmin[tid][box] = lo;
                    if (hi > t_wmax[tid][box]) t_wmax[tid][box] = hi;
                }
            }
        }
    }
    for (int t = 0; t < num_threads; ++t)
        for (int64_t i = 0; i < n_boxes; ++i)
        {
            counts[i] += t_counts[t][i];
            wmin[i] = std::min(wmin[i], t_wmin[t][i]);
            wmax[i] = std::max(wmax[i], t_wmax[t][i]);
        }
}

// ---------------------------------------------------------------------
// Packed-ingest planner (parallel/packed.py plan_packed): the per-entry
// geometry + bucket assignment + stable counting sort + tap table
// lookups, in two OpenMP passes. The Python planner enumerates tasks
// (np.unique) and per-task tower bounds first, then calls:
//   1. sdp_host_packed_buckets: per-(row, chan) bucket id + counts
//   2. (Python: pad counts to block multiples, prefix sums)
//   3. sdp_host_packed_fill: place entries in stable bucket order and
//      write the padded sorted arrays incl. f32 tap-table rows.
// Mirrors the reference's bucket-sort tiling (sdp_tiled_functions.cpp)
// fused with the tap addressing of sdp_gridder_wtower_uvw.cpp:126-142.

namespace {

inline double round_half_away(double x)
{
    return x >= 0.0 ? std::floor(x + 0.5) : std::ceil(x - 0.5);
}

inline int64_t floor_div(int64_t a, int64_t b)
{
    int64_t q = a / b, r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

inline int64_t floor_mod(int64_t a, int64_t b)
{
    int64_t r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

struct PackedGeom
{
    double freq0, dfreq, eff_sg_dist, theta, w_step, height;
    int64_t num_chan, ov, w_ov, sgs, support, w_support;
};

// Per-entry geometry shared by both passes (must mirror plan_packed's
// NumPy arithmetic exactly).
inline void packed_entry(const PackedGeom& g, const double* uvw,
                         int64_t row, int64_t ch,
                         const int64_t* first_t, const int64_t* off_w_t,
                         int64_t task,
                         int64_t* iu0, int64_t* iv0,
                         int64_t* u_frac, int64_t* v_frac,
                         int64_t* j, int64_t* w_row)
{
    const double sc = (g.freq0 + g.dfreq * (double)ch) / kC0;
    const double u = uvw[3 * row + 0] * sc;
    const double v = uvw[3 * row + 1] * sc;
    const double w = uvw[3 * row + 2] * sc;
    const double d = g.eff_sg_dist;
    const int64_t biu = (int64_t)std::floor(u / d + 0.5);
    const int64_t biv = (int64_t)std::floor(v / d + 0.5);
    const int64_t half_ov =
        (g.sgs / 2 - g.support / 2 + 1) * g.ov;
    const double u_rel = u - (double)biu * d;
    const double v_rel = v - (double)biv * d;
    const int64_t iu0_ov =
        (int64_t)round_half_away(u_rel * (g.theta * (double)g.ov))
        + half_ov;
    const int64_t iv0_ov =
        (int64_t)round_half_away(v_rel * (g.theta * (double)g.ov))
        + half_ov;
    int64_t iu = floor_div(iu0_ov, g.ov);
    int64_t iv = floor_div(iv0_ov, g.ov);
    iu = std::min(std::max(iu, (int64_t)0), g.sgs - g.support);
    iv = std::min(std::max(iv, (int64_t)0), g.sgs - g.support);
    *iu0 = iu;
    *iv0 = iv;
    *u_frac = floor_mod(iu0_ov, g.ov);
    *v_frac = floor_mod(iv0_ov, g.ov);

    const double w_rel = w - (double)off_w_t[task] * g.w_step;
    const int64_t jj = (int64_t)std::floor(w_rel / g.w_step) + 1
        - first_t[task];
    const double w_rel2 =
        w_rel - (double)(first_t[task] + jj - 1) * g.w_step;
    *j = jj;
    *w_row = floor_mod(
        (int64_t)round_half_away(w_rel2 * ((double)g.w_ov / g.w_step)),
        g.w_ov);
}

// Pass-1 subset of packed_entry: only the u-octet (iu0) and the slab
// index j — the bucket key needs nothing else, and the v/w-row
// rounding work is ~40% of the full per-entry geometry. MUST stay
// arithmetic-identical to packed_entry's iu0/j path.
inline void packed_entry_uj(const PackedGeom& g, const double* uvw,
                            int64_t row, int64_t ch,
                            const int64_t* first_t,
                            const int64_t* off_w_t, int64_t task,
                            int64_t* iu0, int64_t* j)
{
    const double sc = (g.freq0 + g.dfreq * (double)ch) / kC0;
    const double u = uvw[3 * row + 0] * sc;
    const double w = uvw[3 * row + 2] * sc;
    const double d = g.eff_sg_dist;
    const int64_t biu = (int64_t)std::floor(u / d + 0.5);
    const int64_t half_ov =
        (g.sgs / 2 - g.support / 2 + 1) * g.ov;
    const double u_rel = u - (double)biu * d;
    const int64_t iu0_ov =
        (int64_t)round_half_away(u_rel * (g.theta * (double)g.ov))
        + half_ov;
    int64_t iu = floor_div(iu0_ov, g.ov);
    *iu0 = std::min(std::max(iu, (int64_t)0), g.sgs - g.support);

    const double w_rel = w - (double)off_w_t[task] * g.w_step;
    *j = (int64_t)std::floor(w_rel / g.w_step) + 1 - first_t[task];
}

}  // namespace

// Pass 1: per-entry bucket ids + per-bucket counts. Returns the number
// of entries whose slab index is out of the task's tower range (the
// processed-vis invariant; caller raises when non-zero).
int64_t sdp_host_packed_buckets(
    const double* uvw, int64_t num_rows,
    double freq0_hz, double dfreq_hz, int64_t num_chan,
    double eff_sg_dist, double theta, double w_step, double height,
    int64_t ov, int64_t w_ov, int64_t sgs, int64_t support,
    int64_t w_support,
    const int64_t* task_id, const int64_t* first_t,
    const int64_t* off_w_t, const int64_t* num_planes_t,
    int64_t num_slabs, int64_t num_octets, int64_t num_buckets,
    int64_t* bucket, int64_t* counts)
{
    const PackedGeom g{freq0_hz, dfreq_hz, eff_sg_dist, theta, w_step,
                       height, num_chan, ov, w_ov, sgs, support,
                       w_support};
    for (int64_t i = 0; i < num_buckets; ++i) counts[i] = 0;
    int64_t bad = 0;
#ifdef _OPENMP
    const int num_threads = omp_get_max_threads();
#else
    const int num_threads = 1;
#endif
    std::vector<std::vector<int64_t>> t_counts(
        num_threads, std::vector<int64_t>(num_buckets, 0));

#pragma omp parallel for schedule(static) reduction(+ : bad)
    for (int64_t r = 0; r < num_rows; ++r)
    {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
#else
        const int tid = 0;
#endif
        for (int64_t c = 0; c < num_chan; ++c)
        {
            const int64_t e = r * num_chan + c;
            const int64_t task = task_id[e];
            int64_t iu0, j;
            packed_entry_uj(g, uvw, r, c, first_t, off_w_t, task,
                            &iu0, &j);
            if (j < 0 || j >= num_planes_t[task]) bad += 1;
            // Out-of-range j aborts the plan (bad > 0) — clamp so the
            // count write stays in bounds until the caller raises.
            int64_t b =
                (task * num_slabs + j) * num_octets + (iu0 >> 3);
            b = std::min(std::max(b, (int64_t)0), num_buckets - 1);
            bucket[e] = b;
            t_counts[tid][b] += 1;
        }
    }
    for (int t = 0; t < num_threads; ++t)
        for (int64_t i = 0; i < num_buckets; ++i)
            counts[i] += t_counts[t][i];
    return bad;
}

// Pass 2: stable placement into the padded stream + tap table lookups.
// pad_off: [num_buckets + 1] start offsets of each padded bucket (the
// last entry is the padded total); uv_table: [ov+1, support] f64;
// w_table: [w_ov+1, w_support] f64. Output arrays may be allocated
// with np.empty: every pad slot is zeroed here (sequential writes at
// the tail of each bucket run — the caller-side np.zeros memset of the
// full 60 B/vis stream cost ~0.6 s per warm 4M-vis plan build).
void sdp_host_packed_fill(
    const double* uvw, int64_t num_rows,
    double freq0_hz, double dfreq_hz, int64_t num_chan,
    double eff_sg_dist, double theta, double w_step, double height,
    int64_t ov, int64_t w_ov, int64_t sgs, int64_t support,
    int64_t w_support,
    const int64_t* task_id, const int64_t* first_t,
    const int64_t* off_w_t,
    const int64_t* bucket, const int64_t* pad_off,
    int64_t num_buckets,
    const double* uv_table, const double* w_table,
    int64_t* sort_index, uint8_t* valid,
    int32_t* u_off, int32_t* iv0_out,
    float* uk, float* vk, float* wk,
    int32_t* u_frac, int32_t* v_frac, int32_t* w_row_out)
{
    const PackedGeom g{freq0_hz, dfreq_hz, eff_sg_dist, theta, w_step,
                       height, num_chan, ov, w_ov, sgs, support,
                       w_support};
    std::vector<int64_t> cursor(pad_off, pad_off + num_buckets);
    const int64_t num_vis = num_rows * num_chan;
    // Sequential stable placement (matches numpy's stable argsort).
    for (int64_t e = 0; e < num_vis; ++e)
    {
        const int64_t dest = cursor[bucket[e]]++;
        sort_index[dest] = e;
        valid[dest] = 1;
    }
    // Parallel geometry + table fill over destinations, then zero the
    // pad tail of each bucket run (outputs may be np.empty).
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < num_buckets; ++b)
    {
        for (int64_t dest = pad_off[b]; dest < cursor[b]; ++dest)
        {
            const int64_t e = sort_index[dest];
            const int64_t r = e / num_chan, c = e % num_chan;
            const int64_t task = task_id[e];
            int64_t iu0, iv0, uf, vf, j, wr;
            packed_entry(g, uvw, r, c, first_t, off_w_t, task,
                         &iu0, &iv0, &uf, &vf, &j, &wr);
            u_off[dest] = (int32_t)(iu0 & 7);
            iv0_out[dest] = (int32_t)iv0;
            u_frac[dest] = (int32_t)uf;
            v_frac[dest] = (int32_t)vf;
            w_row_out[dest] = (int32_t)wr;
            for (int64_t s = 0; s < support; ++s)
            {
                uk[dest * support + s] =
                    (float)uv_table[uf * support + s];
                vk[dest * support + s] =
                    (float)uv_table[vf * support + s];
            }
            for (int64_t s = 0; s < w_support; ++s)
                wk[dest * w_support + s] =
                    (float)w_table[wr * w_support + s];
        }
        const int64_t pad_lo = cursor[b], pad_hi = pad_off[b + 1];
        const int64_t npad = pad_hi - pad_lo;
        if (npad <= 0) continue;
        std::memset(sort_index + pad_lo, 0, npad * sizeof(int64_t));
        std::memset(valid + pad_lo, 0, npad);
        std::memset(u_off + pad_lo, 0, npad * sizeof(int32_t));
        std::memset(iv0_out + pad_lo, 0, npad * sizeof(int32_t));
        std::memset(u_frac + pad_lo, 0, npad * sizeof(int32_t));
        std::memset(v_frac + pad_lo, 0, npad * sizeof(int32_t));
        std::memset(w_row_out + pad_lo, 0, npad * sizeof(int32_t));
        std::memset(uk + pad_lo * support, 0,
                    npad * support * sizeof(float));
        std::memset(vk + pad_lo * support, 0,
                    npad * support * sizeof(float));
        std::memset(wk + pad_lo * w_support, 0,
                    npad * w_support * sizeof(float));
    }
}

// Task enumeration for the packed planner: per-(row, chan) box keys
// (the same packed scalar key as plan_packed's NumPy path:
// ((biw + S/2)*S + (biu + S/2))*S + (biv + S/2), S = 1<<20), unique
// tasks in ascending key order (np.unique semantics), per-entry task
// ids, and per-task scaled-w bounds — one OpenMP pass + a small merge,
// replacing the O(V log V) np.unique / argsort / reduceat stages.
//
// keys_out: caller-allocated [max_tasks]; returns the number of unique
// tasks found, or -1 if it exceeds max_tasks (caller falls back).
int64_t sdp_host_packed_tasks(
    const double* uvw, int64_t num_rows,
    double freq0_hz, double dfreq_hz, int64_t num_chan,
    double eff_sg_dist, double w_stack_dist,
    int64_t max_tasks,
    int64_t* task_id, int64_t* keys_out,
    double* wmin_out, double* wmax_out)
{
    constexpr int64_t kSpan = (int64_t)1 << 20;
    constexpr int64_t kHalf = kSpan / 2;
#ifdef _OPENMP
    const int num_threads = omp_get_max_threads();
#else
    const int num_threads = 1;
#endif
    struct Bounds
    {
        double lo = INFINITY, hi = -INFINITY;
    };
    std::vector<std::unordered_map<int64_t, Bounds>> t_maps(num_threads);

#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < num_rows; ++r)
    {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
#else
        const int tid = 0;
#endif
        auto& map = t_maps[tid];
        for (int64_t c = 0; c < num_chan; ++c)
        {
            const double sc = (freq0_hz + dfreq_hz * (double)c) / kC0;
            const double u = uvw[3 * r + 0] * sc;
            const double v = uvw[3 * r + 1] * sc;
            const double w = uvw[3 * r + 2] * sc;
            const int64_t biu =
                (int64_t)std::floor(u / eff_sg_dist + 0.5);
            const int64_t biv =
                (int64_t)std::floor(v / eff_sg_dist + 0.5);
            const int64_t biw =
                (int64_t)std::floor(w / w_stack_dist + 0.5);
            const int64_t key =
                ((biw + kHalf) * kSpan + (biu + kHalf)) * kSpan
                + (biv + kHalf);
            task_id[r * num_chan + c] = key;  // temp: raw key
            auto& b = map[key];
            b.lo = std::min(b.lo, w);
            b.hi = std::max(b.hi, w);
        }
    }

    // Merge per-thread maps; ascending-key order == np.unique order.
    std::unordered_map<int64_t, Bounds> merged;
    for (auto& m : t_maps)
        for (auto& kv : m)
        {
            auto& b = merged[kv.first];
            b.lo = std::min(b.lo, kv.second.lo);
            b.hi = std::max(b.hi, kv.second.hi);
        }
    const int64_t num_tasks = (int64_t)merged.size();
    if (num_tasks > max_tasks) return -1;
    std::vector<int64_t> keys;
    keys.reserve(merged.size());
    for (auto& kv : merged) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    for (int64_t t = 0; t < num_tasks; ++t)
    {
        keys_out[t] = keys[t];
        const Bounds& b = merged[keys[t]];
        wmin_out[t] = b.lo;
        wmax_out[t] = b.hi;
    }

    // Raw key -> dense ascending id.
    const int64_t num_vis = num_rows * num_chan;
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < num_vis; ++e)
    {
        task_id[e] = (int64_t)(std::lower_bound(keys.begin(), keys.end(),
                                                task_id[e])
                               - keys.begin());
    }
    return num_tasks;
}

// Chunked content digest (plan cache identity, not crypto): each
// 1 MiB chunk hashes independently (OpenMP) and the chunk hashes
// combine sequentially, so the result is thread-count invariant.
// Within a chunk the FNV-1a round eats 8 bytes per multiply with an
// xorshift mix (byte-at-a-time measured 390 MB/s on the single-core
// build host — the digest was ~15% of a warm 4M-vis plan build).
uint64_t sdp_host_hash64(const uint8_t* data, int64_t n, uint64_t seed)
{
    constexpr int64_t kChunk = (int64_t)1 << 20;
    const int64_t num_chunks = n == 0 ? 0 : (n + kChunk - 1) / kChunk;
    std::vector<uint64_t> h(num_chunks);
#pragma omp parallel for schedule(static)
    for (int64_t cidx = 0; cidx < num_chunks; ++cidx)
    {
        uint64_t acc = 1469598103934665603ULL;
        const int64_t lo = cidx * kChunk;
        const int64_t hi = std::min(n, lo + kChunk);
        int64_t i = lo;
        for (; i + 8 <= hi; i += 8)
        {
            uint64_t v;
            std::memcpy(&v, data + i, 8);
            acc ^= v;
            acc *= 1099511628211ULL;
            acc ^= acc >> 29;
        }
        for (; i < hi; ++i)
        {
            acc ^= (uint64_t)data[i];
            acc *= 1099511628211ULL;
        }
        h[cidx] = acc;
    }
    uint64_t out = seed;
    for (int64_t cidx = 0; cidx < num_chunks; ++cidx)
    {
        out ^= h[cidx] + 0x9e3779b97f4a7c15ULL + (out << 6) + (out >> 2);
    }
    return out;
}

// Stable argsort of rows by their w coordinate — the host-side bucket
// sort that gives the device kernels w-locality (the analogue of
// sdp_tiled_functions' GPU bucket sort).
void sdp_host_sort_rows_by_w(const double* uvw, int64_t num_rows,
                            int64_t* perm)
{
    for (int64_t i = 0; i < num_rows; ++i) perm[i] = i;
    std::stable_sort(perm, perm + num_rows,
                     [&](int64_t a, int64_t b)
                     { return uvw[3 * a + 2] < uvw[3 * b + 2]; });
}

// Exclusive prefix sum (sdp_count_and_prefix_sum's second half).
void sdp_host_prefix_sum(const int64_t* counts, int64_t n,
                        int64_t* offsets)
{
    int64_t acc = 0;
    for (int64_t i = 0; i < n; ++i)
    {
        offsets[i] = acc;
        acc += counts[i];
    }
    offsets[n] = acc;
}

}  // extern "C"
