// The block size of the hand-written kernels that include flash_common.cuh
// or slab_common.cuh, defined once so that a source may include both.

#pragma once

namespace {

constexpr int kThreads = 256;   // 8 warps

}  // namespace
