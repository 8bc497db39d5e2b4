// The grid group of tests/cuda_host/cuda_runtime.h: a grid sync is a
// barrier of every host thread of the launch.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() { host_grid->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
