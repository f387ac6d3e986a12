// K1 at the square-feet biped's four shapes (contact_model=4, nc=8: the
// SRBD OCP at nx=61, nu=48 and the LIP OCP at nx=54, nu=27, each under Euler
// and under RK), all three forms each: instances 40-51 of
// kernels/riccati.py::KERNEL_INSTANCES, with K2's standalone entry at
// nu = 48 and 27. The kernel is csrc/riccati_backward.cu's, included here
// with K1_SQUARE_FEET defined, which picks these instantiations; built into
// a library of its own (kernels/build.py) so that nvcc compiles it beside
// riccati_backward.cu, in parallel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#define K1_SQUARE_FEET
#include "riccati_backward.cu"
