// The C library's single-precision cos, sin and pow over an array.
//
// jnp.cos, jnp.sin and jnp.power on XLA:CPU round as glibc's cosf, sinf
// and powf, which are not correctly rounded: torch's own f32 cos/sin/pow
// on the CPU differ from them in a few percent of arguments, and rounding
// from f64 in about one percent.  The plain PyTorch path calls these loops
// (ops/rounding.py) where an angle picks a direction (the NEE cone, the
// thin lens, the scatter's unit vector, the camera's orbits) and in
// Schlick's reflectance, so that its paths stay on the JAX package's bits.
// Built with g++ without fast math: each call is the library's own
// function, never a vector variant, and the loops stay apart so that no
// sincosf is formed.

#include <math.h>

extern "C" void grt_cosf(const float* x, float* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = cosf(x[i]);
}

extern "C" void grt_sinf(const float* x, float* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = sinf(x[i]);
}

extern "C" void grt_powf(const float* x, float e, float* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = powf(x[i], e);
}
