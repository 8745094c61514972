// The slasher's span update: the min-max surround spans of the listed
// validator rows, in place, for one or many attestation datas a launch.
//
//   lt_span_update_many  replaces lodestar_tpu/slasher/device.py
//   lt_span_update       span_update_planes (:39), the jitted whole-window
//                        masked update of JaxSpanState.apply; the second
//                        is the one-data case of the first's kernel
//
// For an attestation data with window-relative source column s and
// target column t, every listed row r and column c:
//
//   min[r, c] = min(min[r, c], t - c)   for c < s
//   max[r, c] = max(max[r, c], t - c)   for s < c < t
//
// and every other cell keeps its value, so the planes equal
// span_update_planes' outputs for the mask of the listed rows.  s may be
// negative (a source below the window base: only the max update lands)
// and either column may lie past the window; only the columns of the two
// ranges inside [0, H) can change.  A launch of D datas equals the D
// updates one after another.
//
// What bounds it: bytes.  A cell is one int32 read and, where the span
// moves, one write, with one compare beside it, so the least time is the
// touched cells' bytes over the memory rate (3.35 TB/s), and for the few
// columns a live epoch touches (t - base is small after each
// finalization) the launch itself.  JAX's version reads and writes both
// whole planes for every data (32 GiB at 1M validators x 4,096 epochs).
//
// Design.  A work item is one listed row and one vector of W columns of
// that data's touched range [0, span_last(h, s, t)): W = 4, one int4
// (16-byte) load and store a plane, where a row's base is 16-byte aligned
// (h % 4 == 0 and 16-byte aligned planes, as at 4,096 epochs); else W = 1,
// one int32 (the CPU tests' small odd h).  Work items are numbered data
// after data, row-major in each data, and one thread takes one item: the
// host writes the prefix of the datas' item counts (`items`, D + 1
// entries: a data's rows x vectors), and a thread finds its data by
// binary search in it.  So a narrow data (3 columns: one vector a row)
// gives every thread of a block a row, where a block per row left 253 of
// 256 threads idle, and a wide one (4,094 columns: 1,024 vectors a row)
// gives a warp 512 consecutive bytes of one row.  A thread issues the
// loads of both planes (only those its vector can change) before the
// compares, and stores a plane's vector only where a lane changed.  2,048
// threads an SM keep 32 KB in flight an SM for one plane, above the ~20 KB
// that 3.35 TB/s needs at ~0.8 us of latency over 132 SMs.
//
// Rows repeated inside one data are harmless (min and max are idempotent,
// and both threads store the same vector).  Rows repeated across datas of
// one launch would race on the card, so the caller keeps them out:
// TorchSpanState (slasher/device.py) drains its pending batch before an
// apply whose rows meet a pending row.  A row index outside [0, V) is
// skipped.
//
// The same source compiles with a host C++ compiler for the CPU tests
// (tests/test_torch_slasher.py): the work items run one after another,
// forwards or reversed, through the same item function.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SPAN_DEV __device__ __forceinline__
#define SPAN_HOST_DEV __host__ __device__ __forceinline__
#else
#define SPAN_DEV static inline
#define SPAN_HOST_DEV static inline
#endif

#define SPAN_THREADS 256
#define SPAN_ERR_VALUE 1  // cudaErrorInvalidValue

// The columns an update can change are [0, span_last(...)): the min
// update's [0, s) and the max update's (s, t), inside [0, h); 0 when both
// are empty (as for consecutive epochs' votes at the window base, s = 0,
// t = 1), and then the data has no work item.
SPAN_HOST_DEV int span_last(int h, int s_col, int t_col) {
  const long long n_min = s_col < 0 ? 0 : (s_col < h ? s_col : h);
  const long long lo = (long long)s_col + 1 > 0 ? (long long)s_col + 1 : 0;
  const long long hi = t_col < h ? t_col : h;
  const long long max_end = lo < hi ? hi : 0;
  return (int)(n_min > max_end ? n_min : max_end);
}

// The datas of a launch.  seg == NULL: one data, its rows [0, n_rows),
// its columns s0 and t0 (lt_span_update); else data d's rows are
// rows[seg[d], seg[d + 1]), its columns s_cols[d] and t_cols[d], its
// work items [items[d], items[d + 1]).
struct SpanPlan {
  const int64_t *seg, *s_cols, *t_cols, *items;
  int n_data, s0, t0;
};

// t - c, wrapping as int32 arithmetic does (JAX's int32 planes)
SPAN_HOST_DEV int32_t span_dist(int t_col, int col) { return (int32_t)((uint32_t)t_col - (uint32_t)col); }

// One work item: W columns from col0 of one row.  The loads come first,
// then the compares; a plane's vector is stored only where a lane moved.
// Columns at or past span_last satisfy neither range, so a whole vector
// needs no mask.
template <int W>
SPAN_DEV void span_item(int32_t *mn, int32_t *mx, size_t at, int col0, int s_col, int t_col) {
  const bool do_min = col0 < s_col;
  const bool do_max = (long long)col0 + W - 1 > s_col && col0 < t_col;
  int32_t a[W], b[W];
#ifdef __CUDACC__
  if constexpr (W == 4) {
    int4 va = make_int4(0, 0, 0, 0), vb = va;
    if (do_min) va = *(const int4 *)(mn + at);
    if (do_max) vb = *(const int4 *)(mx + at);
    a[0] = va.x, a[1] = va.y, a[2] = va.z, a[3] = va.w;
    b[0] = vb.x, b[1] = vb.y, b[2] = vb.z, b[3] = vb.w;
  } else
#endif
  {
#pragma unroll
    for (int i = 0; i < W; i++) {
      a[i] = do_min ? mn[at + i] : 0;
      b[i] = do_max ? mx[at + i] : 0;
    }
  }
  bool moved_min = false, moved_max = false;
#pragma unroll
  for (int i = 0; i < W; i++) {
    const int col = col0 + i;
    const int32_t dist = span_dist(t_col, col);
    if (do_min && col < s_col && dist < a[i]) a[i] = dist, moved_min = true;
    if (do_max && col > s_col && col < t_col && dist > b[i]) b[i] = dist, moved_max = true;
  }
#ifdef __CUDACC__
  if constexpr (W == 4) {
    if (moved_min) *(int4 *)(mn + at) = make_int4(a[0], a[1], a[2], a[3]);
    if (moved_max) *(int4 *)(mx + at) = make_int4(b[0], b[1], b[2], b[3]);
    return;
  }
#endif
#pragma unroll
  for (int i = 0; i < W; i++) {
    if (moved_min) mn[at + i] = a[i];
    if (moved_max) mx[at + i] = b[i];
  }
}

// Work item g of the plan: its data (binary search over the item prefix),
// its row and vector, then span_item.
template <int W>
SPAN_DEV void span_work(int32_t *mn, int32_t *mx, const int64_t *rows, const SpanPlan &p, int v, int h,
                        long long g) {
  long long item0 = 0, row0 = 0;
  int s_col = p.s0, t_col = p.t0;
  if (p.seg) {
    int lo = 0, hi = p.n_data;  // items[lo] <= g < items[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (p.items[mid] <= g) lo = mid;
      else hi = mid;
    }
    item0 = p.items[lo], row0 = p.seg[lo];
    s_col = (int)p.s_cols[lo], t_col = (int)p.t_cols[lo];
  }
  const int nv = (span_last(h, s_col, t_col) + W - 1) / W;
  const long long k = g - item0;
  long long i;
  int j;
  if (k <= 0xffffffffLL) {  // the 32-bit division, as every launch of the path has
    const uint32_t k32 = (uint32_t)k;
    i = k32 / (uint32_t)nv, j = (int)(k32 - (uint32_t)i * (uint32_t)nv);
  } else {
    i = k / nv, j = (int)(k - i * nv);
  }
  const int64_t row = rows[row0 + i];
  if (row < 0 || row >= v) return;
  span_item<W>(mn, mx, (size_t)row * h + (size_t)j * W, j * W, s_col, t_col);
}

// W = 4 where every row's base is 16-byte aligned, else 1 (kernels/spans.py
// span_width mirrors it to write the item prefix; lt_span_update_many
// refuses a width the planes cannot take)
static int span_width(const void *mn, const void *mx, int h) {
  return (h % 4 == 0 && (uintptr_t)mn % 16 == 0 && (uintptr_t)mx % 16 == 0) ? 4 : 1;
}

#ifdef __CUDACC__

template <int W>
__global__ void __launch_bounds__(SPAN_THREADS)
    lt_span_update_kernel(int32_t *__restrict__ mn, int32_t *__restrict__ mx, const int64_t *__restrict__ rows,
                          const SpanPlan p, int v, int h, long long n_items) {
  const long long g = (long long)blockIdx.x * SPAN_THREADS + threadIdx.x;
  if (g < n_items) span_work<W>(mn, mx, rows, p, v, h, g);
}

static int span_launch(void *mn, void *mx, const void *rows, const SpanPlan &p, int v, int h, int width,
                       long long n_items, void *stream) {
  if (n_items > 0) {
    const long long blocks = (n_items + SPAN_THREADS - 1) / SPAN_THREADS;
    if (blocks > 0x7fffffffLL) return SPAN_ERR_VALUE;
    if (width == 4)
      lt_span_update_kernel<4><<<(unsigned)blocks, SPAN_THREADS, 0, (cudaStream_t)stream>>>(
          (int32_t *)mn, (int32_t *)mx, (const int64_t *)rows, p, v, h, n_items);
    else
      lt_span_update_kernel<1><<<(unsigned)blocks, SPAN_THREADS, 0, (cudaStream_t)stream>>>(
          (int32_t *)mn, (int32_t *)mx, (const int64_t *)rows, p, v, h, n_items);
  }
  return (int)cudaGetLastError();
}

#else  // the host build: the work items one after another

// The host hook every kernel library exports for the tests
// (kernels/build.py load_host): the work items forwards or
// (lt_host_warp_order(1)) reversed.
static int span_host_rev;
extern "C" void lt_host_warp_order(int reversed) { span_host_rev = reversed; }

static int span_launch(void *mn, void *mx, const void *rows, const SpanPlan &p, int v, int h, int width,
                       long long n_items, void *stream) {
  (void)stream;
  for (long long i = 0; i < n_items; i++) {
    const long long g = span_host_rev ? n_items - 1 - i : i;
    if (width == 4)
      span_work<4>((int32_t *)mn, (int32_t *)mx, (const int64_t *)rows, p, v, h, g);
    else
      span_work<1>((int32_t *)mn, (int32_t *)mx, (const int64_t *)rows, p, v, h, g);
  }
  return 0;
}

#endif

// One data: n_rows rows, columns s_col and t_col.
extern "C" int lt_span_update(void *mn, void *mx, const void *rows, int n_rows, int v, int h, int s_col, int t_col,
                              void *stream) {
  const SpanPlan p = {NULL, NULL, NULL, NULL, 1, s_col, t_col};
  const int width = span_width(mn, mx, h);
  const long long nv = (span_last(h, s_col, t_col) + width - 1) / width;
  return span_launch(mn, mx, rows, p, v, h, width, n_rows > 0 ? (long long)n_rows * nv : 0, stream);
}

// n_data datas: seg [D + 1] row offsets into rows, s_cols and t_cols [D],
// items [D + 1] the prefix of the datas' work items at `width` columns an
// item (items[D] = n_items), all int64 on the device.  A width that the
// planes cannot take is refused.
extern "C" int lt_span_update_many(void *mn, void *mx, const void *rows, const void *seg, const void *s_cols,
                                   const void *t_cols, const void *items, int n_data, int v, int h, int width,
                                   long long n_items, void *stream) {
  if (width != 1 && width != span_width(mn, mx, h)) return SPAN_ERR_VALUE;
  if (n_data <= 0 || n_items <= 0) return span_launch(mn, mx, rows, SpanPlan{}, v, h, width, 0, stream);
  const SpanPlan p = {(const int64_t *)seg, (const int64_t *)s_cols, (const int64_t *)t_cols, (const int64_t *)items,
                      n_data, 0, 0};
  return span_launch(mn, mx, rows, p, v, h, width, n_items, stream);
}
