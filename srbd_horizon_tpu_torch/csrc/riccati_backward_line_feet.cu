// K1 at the line-feet quadruped's four shapes (contact_model=2 on four
// legs, nc=8: the SRBD OCP at nx=61, nu=48 and the LIP OCP at nx=54,
// nu=27, each under Euler and under RK), all three forms each: instances
// 52-63 of kernels/riccati.py::KERNEL_INSTANCES. The kernel is
// csrc/riccati_backward.cu's, included here with K1_LINE_FEET defined,
// which picks these instantiations; built into a library of its own
// (kernels/build.py) so that nvcc compiles it beside the other two, in
// parallel. K2's standalone entry at nu = 48 and 27 is the square-feet
// library's; this one answers UNKNOWN_SHAPE for it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#define K1_LINE_FEET
#include "riccati_backward.cu"
