// A `kernel-ok` with nothing left to suppress: only --strict-suppressions
// flags it.  Parsed, never compiled.

// kernel-ok: the undeclared entry this excused was deleted
__global__ void tidy_kernel(float* x) { x[0] = 1.f; }
