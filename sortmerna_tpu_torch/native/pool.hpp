// One process-wide pool of host worker threads for the native engine
// (pool.cpp): the seed probe (probe.cpp), the batched FSM start
// (engine.cpp) and the many-slice pump (driver.cpp) run their chunks on
// it instead of starting and joining threads on every call.

#pragma once

#include <atomic>
#include <cstdint>
#include <functional>

namespace smr {

// Run task(i) for every i in [0, n) on `width` threads: the caller and up
// to width - 1 of the pool's workers, each taking the next index from a
// shared counter.  Returns once every task has returned.  Runs the tasks
// inline, in order, when width or n is 1, or when the calling thread is
// itself running a pool task, so that nothing nests.  The pool is made at
// the first call that needs it and resized when `width` changes.
void pool_for(int width, int64_t n, const std::function<void(int64_t)>& task);

// Nanoseconds the pool's workers spend on the tasks of pool_for calls made
// on this thread are added to *sink while it is set (nullptr: none).  The
// caller's own time is its own to count.
void pool_set_sink(std::atomic<int64_t>* sink);

}  // namespace smr
