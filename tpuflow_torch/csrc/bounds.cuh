// Bounds guards for the checked build of the kernels (kernels/_build.py,
// `build(..., checked=True)`), which compiles every source with
// -DTPUFLOW_BOUNDS_CHECK.  There each guard traps (`__trap()`, which fails
// the launch and poisons the CUDA context) unless the index lies inside the
// extent of the tensor it reads or writes; indices and extents count
// elements, extents are the tensors' sizes as the C entry was given them,
// and an index is the distance of the address actually used from the
// tensor's start.  Without the define every guard compiles to nothing and
// its arguments are never evaluated, so the default build, and every time
// measured with it, is unchanged.
#pragma once

#ifdef TPUFLOW_BOUNDS_CHECK
#define TF_CHECK(cond) \
  do {                 \
    if (!(cond)) __trap(); \
  } while (0)
#else
#define TF_CHECK(cond) \
  do {                 \
  } while (0)
#endif

// [i, i + k) inside [0, n).
#define TF_IN(i, k, n) ((long long)(i) >= 0 && (long long)(i) + (long long)(k) <= (long long)(n))
#define TF_GUARD_SPAN(i, k, n) TF_CHECK(TF_IN(i, k, n))
#define TF_GUARD(i, n) TF_GUARD_SPAN(i, 1, n)
// The same, only where `c` holds (an access made on a condition).
#define TF_GUARD_SPAN_IF(c, i, k, n) TF_CHECK(!(c) || TF_IN(i, k, n))
#define TF_GUARD_IF(c, i, n) TF_GUARD_SPAN_IF(c, i, 1, n)

// The deferred form, for a kernel whose warp-synchronous code an immediate
// trap disturbs: TF_MISS_DECL declares the thread's flag, TF_NOTE*(...)
// record a miss without branching, and TF_TRAP_IF_MISSED() traps once, at
// the kernel's end.
#ifdef TPUFLOW_BOUNDS_CHECK
#define TF_MISS_DECL bool tf_missed_ = false
#define TF_NOTE(cond) (tf_missed_ |= !(cond))
#define TF_TRAP_IF_MISSED() \
  do {                      \
    if (tf_missed_) __trap(); \
  } while (0)
#else
#define TF_MISS_DECL \
  do {               \
  } while (0)
#define TF_NOTE(cond) \
  do {                \
  } while (0)
#define TF_TRAP_IF_MISSED() \
  do {                      \
  } while (0)
#endif
#define TF_NOTE_SPAN(i, k, n) TF_NOTE(TF_IN(i, k, n))
#define TF_NOTE_SPAN_IF(c, i, k, n) TF_NOTE(!(c) || TF_IN(i, k, n))
