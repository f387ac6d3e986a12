// The PTX instructions K1 and K2 issue directly, kept apart so that the
// rest of riccati_backward.cu is plain CUDA C++; K3 (srbd_rollout.cu)
// takes the cp.async helpers for its per-warp double buffer, K6
// (isrbd_rollout.cu) those and the mbarriers between its two warps, the
// evaluation entries of both files the block-wide row staging
// (cp_async_rows), and K11 (lip_rollout.cu) the bulk copies it stages a
// member with (tma_bulk, mbarrier_expect_tx, fence_mbarrier_init).
//
// FP64 tensor-core product, mma.sync.aligned.m16n8k4.row.col.f64 (sm_90
// and later): D (16×8) = A (16×4) · B (4×8) + C, one warp, every lane
// taking part. With g = lane >> 2 and t = lane & 3, each lane holds
//   A: two doubles, A[g][t] and A[g + 8][t];
//   B: one double, B[t][g];
//   C and D: four doubles, C[g][2t], C[g][2t + 1], C[g + 8][2t] and
//   C[g + 8][2t + 1].
// Each output is rounded as c + a₀b₀ + … + a₃b₃ in four fused
// multiply-adds, in order of k (tools/torch_dmma_probe.py).
#pragma once

__device__ __forceinline__ void dmma_m16n8k4(double (&c)[4], double a0,
                                             double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Ask for the 128-byte line holding `p` to be brought into L2; no
// register waits on it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Copy Bytes (4, 8 or 16; both addresses aligned to it) from global to
// shared memory without passing through registers (cp.async, sm_80 and
// later); cp_async_wait_all() waits for every copy this thread has issued.
// A thread may also close its copies into a group (cp_async_commit) and
// wait until at most N of its groups are still in flight
// (cp_async_wait_group<N>).
template <int Bytes>
__device__ __forceinline__ void cp_async(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
               "l"(global), "n"(Bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The kThreads threads of a block (this one is `tid`) copy rows n0 … n1−1
// of a contiguous run of kDim-wide rows (row n at src + n·kDim) into
// shared memory, row n at dst + n·stride, one element a copy: neighbouring
// threads take neighbouring elements, so the reads coalesce whatever the
// width, and the rows land wherever the kernel wants them.
template <typename T, int kDim, int kThreads>
__device__ __forceinline__ void cp_async_rows(T* dst, int stride,
                                              const T* src, int n0, int n1,
                                              int tid) {
  for (int i = n0 * kDim + tid; i < n1 * kDim; i += kThreads) {
    const int n = i / kDim;
    cp_async<sizeof(T)>(dst + n * stride + (i - n * kDim), src + i);
  }
}

// A barrier object in shared memory (mbarrier), for one warp to hand
// shared memory to another: init sets the arrivals a phase takes;
// mbarrier_arrive counts one arrival (release: the arriving thread's
// earlier writes, and those ordered before them, are visible to a thread
// that sees the phase complete); mbarrier_wait returns once the phase
// with the given parity has completed (acquire). Phases alternate in
// parity, so the k-th use of a barrier waits on parity k & 1.
__device__ __forceinline__ void mbarrier_init(unsigned long long* bar, int count) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbarrier_arrive(unsigned long long* bar) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(a) : "memory");
}

__device__ __forceinline__ void mbarrier_wait(unsigned long long* bar, int parity) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// Make the mbarrier inits of this thread visible to the bulk-copy unit
// (before any bulk copy completes on them).
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival on `bar` that also adds `bytes` to the bytes its phase waits
// for (the bulk copies that complete on it).
__device__ __forceinline__ void mbarrier_expect_tx(unsigned long long* bar,
                                                   unsigned bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(a),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory by the bulk-copy unit (cp.async.bulk, sm_90), one
// instruction of one thread; the bytes count against `bar`'s phase.
__device__ __forceinline__ void tma_bulk(void* smem, const void* global,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(d),
      "l"(global), "r"(bytes), "r"(b)
      : "memory");
}
