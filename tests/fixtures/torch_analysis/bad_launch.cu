// Seeded launch-contract violations, read with bad_launch.py (the test
// reads the `expect:` marks).  Parsed, never compiled.

extern "C" int good_launch(const void* a, void* b, int n, long long s,
                           float f, void* stream) {
  return 0;
}

extern "C" int short_launch(const void* a, void* b, int n, void* stream) {
  return 0;
}

extern "C" int typed_launch(const void* a, int n, long long s,
                            void* stream) {
  return 0;
}

extern "C" int wide_launch(double x, void* stream) { return 0; }

extern "C" int ret_launch(void* stream) { return 0; }

extern "C" int hidden_launch(void* stream) { return 0; }  // expect: kc-abi-undeclared

// kernel-ok:
extern "C" int blank_launch(void* stream) { return 0; }  // expect: kc-abi-undeclared, kernel-ok-no-reason
