// Launch contracts kept, read with good_launch.py.  Parsed, never compiled.
#include <cstdint>

/* extern "C" int commented_out_launch(int x); -- a comment, not code */

extern "C" int toy_launch(const void* a, const void* b, void* out, int n,
                          int d, long long stride, float scale,
                          void* stream) {
  return 0;  // "extern \"C\"" in a comment or string is no declaration
}

extern "C" int toy_bwd_launch(const long long* strides, void* dx, int n,
                              void* stream) {
  return 0;
}

// kernel-ok: a host-side probe the tests call through another binding
extern "C" int toy_probe(void) { return 0; }
