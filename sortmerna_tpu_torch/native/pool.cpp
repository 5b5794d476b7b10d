// The native engine's persistent host thread pool (pool.hpp).
//
// A call of pool_for is a job: its tasks are indices [0, n) handed out by
// an atomic counter.  The caller works through them itself and up to
// width - 1 workers join it; a worker takes the first queued job that has
// tasks left and room for a helper, so calls from several threads (read
// shards, the opt-in thread schedulers) share the pool.  Between jobs the
// workers park on a condition variable: a spinning worker would take a
// core from the CLI thread and from torch.  A thread running a task is
// marked, and a pool_for it makes runs inline: no task waits on another.

#include "pool.hpp"

#include <malloc.h>
#include <pthread.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace smr {
namespace {

thread_local bool t_in_task = false;
thread_local std::atomic<int64_t>* t_sink = nullptr;

struct Job {
    const std::function<void(int64_t)>* task;
    int64_t n;
    std::atomic<int64_t> next{0};
    std::atomic<int64_t>* sink;
    int64_t done = 0;           // tasks returned (under Pool::mu)
    int helpers = 0;            // workers inside the job (under Pool::mu)
    int max_helpers = 0;
};

struct Worker {
    std::thread th;
    bool stop = false;          // under Pool::mu
};

struct Pool {
    std::mutex mu;
    std::condition_variable wake;       // workers park here
    std::condition_variable finished;   // callers wait for their job here
    std::vector<std::unique_ptr<Worker>> workers;
    std::vector<Job*> jobs;
};

Pool* g_pool = nullptr;
std::mutex g_make;
std::atomic<int64_t> g_dispatched{0}, g_inline{0};

int64_t now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

// the tasks of `j` this thread ran before none was left
int64_t drain(Job& j) {
    int64_t ran = 0;
    for (int64_t i; (i = j.next.fetch_add(1)) < j.n; ++ran) (*j.task)(i);
    return ran;
}

void work(Pool* p, Worker* self) {
    t_in_task = true;
    std::unique_lock<std::mutex> lk(p->mu);
    for (;;) {
        if (self->stop) return;
        Job* j = nullptr;
        for (Job* c : p->jobs)
            if (c->helpers < c->max_helpers && c->next.load() < c->n) {
                j = c;
                break;
            }
        if (!j) {
            p->wake.wait(lk);
            continue;
        }
        ++j->helpers;
        lk.unlock();
        int64_t t0 = j->sink ? now_ns() : 0;
        int64_t ran = drain(*j);
        if (j->sink) *j->sink += now_ns() - t0;
        lk.lock();
        --j->helpers;
        j->done += ran;
        if (j->done == j->n && j->helpers == 0) p->finished.notify_all();
    }
}

// a child of fork() has none of the parent's workers: it starts afresh
// (the parent's pool is left behind, unused)
void forget_pool() { g_pool = nullptr; }

Pool* pool() {
    std::lock_guard<std::mutex> lk(g_make);
    if (!g_pool) {
        static bool hooked = false;
        if (!hooked) {
            pthread_atfork(nullptr, nullptr, forget_pool);
#ifdef M_ARENA_MAX
            // A worker allocates for whichever slice it pumps (hit lists,
            // FSM state, probe scratch), so a slice's buffers move between
            // threads from pass to pass.  With glibc's arena a thread,
            // every arena keeps the holes they leave: 0.2 GB more peak
            // RSS on the long-read cell.  Two arenas share the holes.
            mallopt(M_ARENA_MAX, 2);
#endif
            hooked = true;
        }
        g_pool = new Pool();    // kept to the process's end: its
    }                           // workers park, and exit goes on
    return g_pool;
}

// give the pool `helpers` workers (with p->mu held; a shrink lets the
// surplus workers finish their current job before they are joined)
void resize(Pool* p, int helpers, std::unique_lock<std::mutex>& lk) {
    while ((int)p->workers.size() < helpers) {
        p->workers.push_back(std::make_unique<Worker>());
        Worker* w = p->workers.back().get();
        w->th = std::thread(work, p, w);
    }
    if ((int)p->workers.size() > helpers) {
        std::vector<std::unique_ptr<Worker>> gone;
        while ((int)p->workers.size() > helpers) {
            gone.push_back(std::move(p->workers.back()));
            p->workers.pop_back();
            gone.back()->stop = true;
        }
        p->wake.notify_all();
        lk.unlock();
        for (auto& w : gone) w->th.join();
        lk.lock();
    }
}

}  // namespace

void pool_for(int width, int64_t n,
              const std::function<void(int64_t)>& task) {
    if (width <= 1 || n <= 1 || t_in_task) {
        if (t_in_task && width > 1) ++g_inline;
        for (int64_t i = 0; i < n; ++i) task(i);
        return;
    }
    Pool* p = pool();
    Job j;
    j.task = &task;
    j.n = n;
    j.sink = t_sink;
    j.max_helpers = (int)std::min<int64_t>(width - 1, n - 1);
    {
        std::unique_lock<std::mutex> lk(p->mu);
        if ((int)p->workers.size() != width - 1) resize(p, width - 1, lk);
        p->jobs.push_back(&j);
    }
    p->wake.notify_all();
    ++g_dispatched;
    t_in_task = true;
    int64_t ran = drain(j);
    t_in_task = false;
    std::unique_lock<std::mutex> lk(p->mu);
    j.done += ran;
    p->finished.wait(lk, [&] { return j.done == j.n && j.helpers == 0; });
    p->jobs.erase(std::find(p->jobs.begin(), p->jobs.end(), &j));
}

void pool_set_sink(std::atomic<int64_t>* sink) { t_sink = sink; }

}  // namespace smr

extern "C" {

// [pool_for calls that ran on the pool, calls wider than 1 that ran
// inline inside a pool task, the pool's workers]
void pool_counts(int64_t* out3) {
    out3[0] = smr::g_dispatched.load();
    out3[1] = smr::g_inline.load();
    std::lock_guard<std::mutex> lk(smr::g_make);
    if (!smr::g_pool) {
        out3[2] = 0;
        return;
    }
    std::lock_guard<std::mutex> pk(smr::g_pool->mu);
    out3[2] = (int64_t)smr::g_pool->workers.size();
}

// fn(i) for i in [0, n) through pool_for: what a C caller does, for tests
void pool_run(int32_t width, int64_t n, void (*fn)(int64_t)) {
    smr::pool_for(width, n, [fn](int64_t i) { fn(i); });
}

}  // extern "C"
