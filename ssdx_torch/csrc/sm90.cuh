// What the Hopper (sm_90a) kernels of the port share: the stage ring of a
// block tile, the mbarrier, TMA, bulk-copy and wgmma helpers, the consumers'
// main loop, and the host's tensor-map encode.  Included by gemm_sm90.cu
// (the bare matmuls S1, S2b), int8_conv.cu (the int8 convolutions B4a,
// B4b), nms.cu (B1's scan) and bn_relu_pool.cu (B6's pipeline); each is
// built into a library of its own.
//
// The main loop (consume): a block computes a BM x BN output tile with BM / 64
// consumer warpgroups of 64 rows each and one loader warpgroup.  K is walked
// BK = 128 bytes at a time through a ring of stages in shared memory, 192 KB
// in all; stage s holds the A tile (BM rows of 128 bytes) and then the B
// tile (BN rows of 128 bytes, or 64 k-rows of BN values when B is N-major),
// both in the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8),
// rows 128 bytes apart from a 1,024-aligned base), as TMA writes it.  The
// loader fills a stage against its "full" mbarrier; the consumers wait on it,
// run wgmma.mma_async from the swizzled tiles, keep one group of wgmmas in
// flight and hand the stage before back through its "empty" mbarrier.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the libraries link no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int BK = 128;        // bytes of K per stage: one 128-byte swizzle row
constexpr int RING = 196608;   // bytes of the stage ring (192 KB)

// A BM x BN block tile: BM / 64 consumer warpgroups of 64 rows each, then
// one loader warpgroup, on a ring of RING_BYTES; a stage holds KB bytes of K
// (128, or 64 in the 64-byte swizzle).
template <int BM, int BN, int RING_BYTES = RING, int KB = BK>
struct Tile {
  static constexpr int CONSUMERS = BM / 64;
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int A_BYTES = BM * KB;
  static constexpr int B_BYTES = BN * KB;   // BN rows (nt) or 64 k-rows of BN values (nn)
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;  // 3 to 8
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers + alignment
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// seconds means a wrong byte count or parity: trap, so that the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// Copy `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

// Copy `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from shared memory to device memory, in this thread's current
// bulk group (cp.async.bulk.commit_group closes it).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// Store one box of the map (64 rows x 128 bytes in the port's kernels) from
// shared memory, 128-byte swizzled, to (c0, c1) of the output; TMA clips
// what lies outside.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// Barrier `id` (1..15) over the first `count` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Tell the compiler that the asynchronous wgmma may have written r.
template <typename T>
__device__ __forceinline__ void fence_operand(T& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle (layout
// 1; 2 is the 64-byte swizzle): start address, leading and stride byte
// offsets, all in 16-byte units.  K-major (8-row groups of 128-byte rows,
// 1,024 bytes apart, or of 64-byte rows 512 apart): LBO unused, SBO the
// group's size.  N-major (rows of 64 values along N, one per k): LBO is the
// distance between 64-wide column blocks, SBO between groups of 8 k-rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout = 1) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// ------------------------------------------------------ wgmma, m64 x BN x 32 bytes
// d += A . B^T for a 64-row slice of A and BN columns, the accumulator held
// as the instruction's fragment: thread t of the warpgroup holds rows
// 16*(t/32) + (t%32)/4 and +8, columns 8j + 2*(t%4) and +1, as d[4j .. 4j+3].

__device__ __forceinline__ void wgmma_s8_128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}


template <int BN, int TRANS_B>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_s8_128(d, da, db);
  else wgmma_s8_256(d, da, db);
}

template <int BN, int TRANS_B>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_bf16_128<TRANS_B>(d, da, db);
  else wgmma_bf16_256<TRANS_B>(d, da, db);
}

// Order this thread's shared-memory accesses in the generic proxy (plain
// stores, completed cp.async copies) before later ones in the async proxy
// (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared memory a kernel's dynamic array starts at, aligned to 1,024
// bytes (the 128-byte swizzle repeats every 8 rows of 128 bytes).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// ------------------------------------------------------------ the main loop
// The consumer warpgroup wg's part of a block tile: nk stages of KB bytes of
// K, stage kb in ring slot kb % STAGES, its A rows wg * 64 .. wg * 64 + 63.
// Returns with every wgmma complete and acc holding the warpgroup's 64 x BN
// sums in the instruction's fragment (see wgmma_s8_128).
// A_BY_THREADS: threads wrote A (cp.async, the generic proxy), so each
// stage is fenced into the async proxy before wgmma reads it.
template <typename Acc, int BM, int BN, bool N_MAJOR_B, bool A_BY_THREADS = false,
          int RING_BYTES = RING, int KB = BK>
__device__ __forceinline__ void consume(Acc (&acc)[BN / 2], unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int nk, int wg) {
  using T = Tile<BM, BN, RING_BYTES, KB>;
  constexpr uint64_t LAYOUT = KB == 128 ? 1 : 2;  // the swizzle of KB-byte rows
  constexpr int STAGES = T::STAGES;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int lane = threadIdx.x & 31;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(&full[s], (kb / STAGES) & 1);
    if constexpr (A_BY_THREADS) fence_proxy_async();
    const uint32_t a = smem_u32(smem + s * T::STAGE_BYTES) + wg * 64 * KB;
    const uint32_t b = smem_u32(smem + s * T::STAGE_BYTES + T::A_BYTES);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk) {
      const uint64_t da = desc(a + kk * 32, 16, 8 * KB, LAYOUT);
      const uint64_t db = N_MAJOR_B ? desc(b + kk * 16 * 128, 8192, 1024)  // 16 k-rows on
                                    : desc(b + kk * 32, 16, 8 * KB, LAYOUT);  // 32 bytes on
      mma<BN, N_MAJOR_B ? 1 : 0>(acc, da, db);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    wgmma_wait<1>();  // the group of stage kb-1 is done: hand its stage back
    if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
}

// -------------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A driver function by name, through the runtime's entry-point query (the
// libraries link no libcuda); null where the driver has none.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

// cuTensorMapEncodeTiled, looked up once.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) fn = (EncodeTiled)driver_entry("cuTensorMapEncodeTiled");
  return fn;
}

// A row-major [outer, inner] matrix, read in boxes of box_outer x box_inner
// values of esize bytes (box_inner * esize = 128: one swizzle row, or 64
// in the 64-byte swizzle).
inline bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize,
                     long long inner, long long outer, int box_inner, int box_outer,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t steps[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Makes device `dev` current for the scope of a call, which also binds its
// primary context to the calling thread: a thread that has made no CUDA
// call yet has none, and cuTensorMapEncodeTiled needs one.
struct OnDevice {
  int prev = -1;
  cudaError_t err;
  explicit OnDevice(int dev) {
    err = dev < 0 || dev >= 64 ? cudaErrorInvalidDevice : cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
    if (prev == dev) prev = -1;  // nothing to restore
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Raise a kernel's dynamic shared memory limit to `bytes` on device `dev`
// (current), unless `configured`, one bit per device, says it is done.
inline cudaError_t reserve_smem(const void* kernel, int bytes, int dev,
                                unsigned long long& configured) {
  if ((configured >> dev) & 1ull) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured |= 1ull << dev;
  return err;
}

}  // namespace sm90
