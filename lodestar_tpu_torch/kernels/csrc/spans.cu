// The slasher's span update: the min-max surround spans of the listed
// validator rows, in place.
//
//   lt_span_update  replaces lodestar_tpu/slasher/device.py
//                   span_update_planes (:39), the jitted whole-window
//                   masked update of JaxSpanState.apply
//
// For one attestation data with window-relative source column s and
// target column t, every listed row r and column c:
//
//   min[r, c] = min(min[r, c], t - c)   for c < s
//   max[r, c] = max(max[r, c], t - c)   for s < c < t
//
// and every other cell keeps its value, so the planes equal
// span_update_planes' outputs for the mask of the listed rows.  s may be
// negative (a source below the window base: only the max update lands)
// and either column may lie past the window; only the columns of the
// two ranges inside [0, H) can change.
//
// What bounds it: bytes.  A cell is one int32 read and, where the span
// moves, one write, with one compare beside it, so the least time is the
// touched cells' bytes over the memory rate (3.35 TB/s), and for the few
// columns a live epoch touches (t - base is small after each
// finalization) the launch itself.  JAX's version reads and writes both
// whole planes for every data (32 GiB at 1M validators x 4,096 epochs,
// ~20 ms); this one touches the listed rows' touched columns only.
// Layout: grid x over the listed rows, grid y over 256-column tiles of
// the touched range, one thread per column, so a warp reads 128
// consecutive bytes of one row.  A row index outside [0, V) is skipped.
// Listed rows may repeat: min and max are idempotent.
//
// The same source compiles with a host C++ compiler (the cells one after
// another, rows forwards or reversed) for the CPU tests
// (tests/test_torch_slasher.py).
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

// The columns an update can change are [0, span_last(...)): the min
// update's [0, s) and the max update's (s, t), inside [0, h); 0 when both
// are empty (as for consecutive epochs' votes at the window base, s = 0,
// t = 1), and then no launch is made.
SPAN_HOST_DEV int span_last(int h, int s_col, int t_col) {
  const long long n_min = s_col < 0 ? 0 : (s_col < h ? s_col : h);
  const long long lo = (long long)s_col + 1 > 0 ? (long long)s_col + 1 : 0;
  const long long hi = t_col < h ? t_col : h;
  const long long max_end = lo < hi ? hi : 0;
  return (int)(n_min > max_end ? n_min : max_end);
}

// one cell of a listed row
SPAN_DEV void span_cell(int32_t *mn, int32_t *mx, size_t at, int col, int s_col, int t_col) {
  const int32_t dist = t_col - col;
  if (col < s_col) {
    if (dist < mn[at]) mn[at] = dist;
  } else if (col > s_col && col < t_col) {
    if (dist > mx[at]) mx[at] = dist;
  }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(SPAN_THREADS)
    lt_span_update_kernel(int32_t *__restrict__ mn, int32_t *__restrict__ mx, const int64_t *__restrict__ rows,
                          int v, int h, int last, int s_col, int t_col) {
  const int col = blockIdx.y * SPAN_THREADS + threadIdx.x;
  if (col >= last) return;
  const int64_t row = rows[blockIdx.x];
  if (row < 0 || row >= v) return;
  span_cell(mn, mx, (size_t)row * h + col, col, s_col, t_col);
}

extern "C" int lt_span_update(void *mn, void *mx, const void *rows, int n_rows, int v, int h, int s_col, int t_col,
                              void *stream) {
  const int last = span_last(h, s_col, t_col);
  if (n_rows > 0 && last > 0) {
    const dim3 grid(n_rows, (last + SPAN_THREADS - 1) / SPAN_THREADS);
    lt_span_update_kernel<<<grid, SPAN_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t *)mn, (int32_t *)mx, (const int64_t *)rows, v, h, last, s_col, t_col);
  }
  return (int)cudaGetLastError();
}

#else  // the host build: the cells one after another

// The host hook every kernel library exports for the tests
// (kernels/build.py load_host): the listed rows forwards or
// (lt_host_warp_order(1)) reversed.
static int span_host_rev;
extern "C" void lt_host_warp_order(int reversed) { span_host_rev = reversed; }

extern "C" int lt_span_update(void *mn, void *mx, const void *rows, int n_rows, int v, int h, int s_col, int t_col,
                              void *stream) {
  (void)stream;
  const int last = span_last(h, s_col, t_col);
  for (int i = 0; i < n_rows; i++) {
    const int64_t row = ((const int64_t *)rows)[span_host_rev ? n_rows - 1 - i : i];
    if (row < 0 || row >= v) continue;
    for (int col = 0; col < last; col++)
      span_cell((int32_t *)mn, (int32_t *)mx, (size_t)row * h + col, col, s_col, t_col);
  }
  return 0;
}

#endif
