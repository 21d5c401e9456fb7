/*!
 * Async dependency engine: the port's copy of the JAX package's native
 * engine (src/engine.cc), built by g++ at first use into the port's
 * build directory (mxnet_tpu_torch/base.py).  Its references are the
 * reference's threaded engine (src/engine/threaded_engine.{h,cc},
 * threaded_engine_perdevice.cc, naive_engine.cc; iface
 * include/mxnet/engine.h:253) and the fork's MyThreadPool.
 *
 * It schedules the host side of the runtime around the card: the
 * WorkersMerge leader's per-key sums, checkpoint writers, custom python
 * ops: anything that must observe read/write ordering on shared
 * resources without blocking the main thread.
 *
 * Semantics held from the reference:
 *  - per-variable FIFO dependency queues with reader/writer access grants
 *    (reference ThreadedVar::AppendReadDependency / AppendWriteDependency,
 *    threaded_engine.h:137-145);
 *  - an op becomes ready when all its variable tokens are granted
 *    (OprBlock::wait hits zero, threaded_engine.h:74) and is then run on a
 *    worker thread, ordered by priority;
 *  - exceptions thrown by an op are captured and re-thrown at the next
 *    WaitForVar on any variable the op wrote, or at WaitForAll (reference
 *    exception propagation, src/engine/threaded_engine.cc:440-531);
 *  - a "naive" synchronous mode for deterministic debugging (reference
 *    MXNET_ENGINE_TYPE=NaiveEngine, src/engine/engine.cc:48).
 *
 * The engine counts into engine_stats.h's block (engine.ops_dispatched,
 * engine.ops_executed, engine.exceptions, engine.pending_ops,
 * engine.run_us, engine.queue_wait_us), which MXTEngineStatsJson hands
 * to the Python telemetry registry.
 */
#include <atomic>
#include <chrono>
#include <cstdio>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <pthread.h>

#include <queue>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "engine_api.h"
#include "engine_stats.h"

namespace mxt {

thread_local std::string g_last_error;

void SetLastError(const std::string &msg) { g_last_error = msg; }

namespace {
// Span clock for the telemetry histograms (steady: spans must survive
// wall-clock jumps).
inline int64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
}  // namespace

// ---------------------------------------------------------------- ThreadPool
// Generic condition-variable task pool (reference fork delta: MyThreadPool,
// include/my_thread_pool.h:14, src/my_thread_pool.cc:1-40).
//
// Fork safety (≙ the reference's pthread_atfork handlers,
// src/initialize.cc:73-100): worker threads do NOT survive fork, so a
// child inheriting a live pool would deadlock on its first Submit/WaitAll.
// Every pool registers itself; a process-wide atfork child handler
// re-initializes each pool's synchronization state and respawns workers.
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false), inflight_(0) {
    if (n <= 0) n = static_cast<int>(std::thread::hardware_concurrency());
    // Independent ops must be able to overlap even on 1-core hosts
    // (reference default: multiple workers per device, env_var.md:50-56).
    if (n < 4) n = 4;
    n_workers_ = n;
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { this->Run(); });
    }
    RegisterAtFork(this);
  }

  ~ThreadPool() {
    UnregisterAtFork(this);
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &t : workers_) t.join();
  }

  // Child-side re-init: parent worker threads do not exist here; their
  // std::thread handles are detached (not joined — nothing to join), the
  // primitives are reconstructed, and fresh workers are spawned over an
  // EMPTY queue: work in flight at fork time is LOST in the child (both
  // the tasks vanished workers were executing and the queued ones, whose
  // closures may reference engine state the child handler also resets) —
  // the reference's child likewise re-creates an empty engine.
  void ReinitAfterFork() {
    for (auto &t : workers_) t.detach();
    workers_.clear();
    new (&mu_) std::mutex();
    new (&cv_) std::condition_variable();
    new (&done_cv_) std::condition_variable();
    stop_ = false;
    while (!tasks_.empty()) tasks_.pop();
    inflight_ = 0;
    for (int i = 0; i < n_workers_; ++i) {
      workers_.emplace_back([this] { this->Run(); });
    }
  }

  // The prepare handler holds EVERY pool's mutex across the fork so the
  // child cannot inherit a torn tasks_ heap from a concurrent Submit.
  void LockForFork() { mu_.lock(); }
  void UnlockForFork() { mu_.unlock(); }

  static void RegisterAtFork(ThreadPool *p);
  static void UnregisterAtFork(ThreadPool *p);

  // Higher priority runs first; FIFO within a priority class (seq
  // tiebreak) — reference engine.h Push(priority) / P3 priority pushes.
  void Submit(std::function<void()> task, int priority = 0) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push({priority, next_seq_++, std::move(task)});
      ++inflight_;
    }
    cv_.notify_one();
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return inflight_ == 0; });
  }

  int size() const { return static_cast<int>(workers_.size()); }

 private:
  struct Task {
    int priority;
    uint64_t seq;
    std::function<void()> fn;
    bool operator<(const Task &o) const {
      // std::priority_queue pops the max element: higher priority first,
      // then lower seq (older) first.
      if (priority != o.priority) return priority < o.priority;
      return seq > o.seq;
    }
  };

  void Run() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        task = std::move(const_cast<Task &>(tasks_.top()).fn);
        tasks_.pop();
      }
      task();
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (--inflight_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::priority_queue<Task> tasks_;
  std::vector<std::thread> workers_;
  bool stop_;
  int64_t inflight_;
  uint64_t next_seq_ = 0;
  int n_workers_ = 0;
};

// ---- process-wide atfork registry (src/initialize.cc:73 parity) ----
// Definitions live after the Engine class below: the handlers quiesce
// BOTH tiers (engines' dependency state and pools' task queues).
class Engine;
namespace forkguard {
void RegisterPool(ThreadPool *p);
void UnregisterPool(ThreadPool *p);
void RegisterEngine(Engine *e);
void UnregisterEngine(Engine *e);
}  // namespace forkguard

void ThreadPool::RegisterAtFork(ThreadPool *p) {
  forkguard::RegisterPool(p);
}

void ThreadPool::UnregisterAtFork(ThreadPool *p) {
  forkguard::UnregisterPool(p);
}

// -------------------------------------------------------------------- Engine
struct Opr;

// Per-variable dependency queue (reference ThreadedVar, threaded_engine.h:107):
// FIFO of pending accesses; head reads are granted while no writer is active,
// a head write is granted when the var is fully idle.
struct Var {
  struct Pending {
    Opr *opr;
    bool is_write;
  };
  std::deque<Pending> queue;
  int active_readers = 0;
  bool writer_active = false;
  uint64_t version = 0;
  bool to_delete = false;
  // Exception captured from a failed op that wrote this var; rethrown at
  // WaitForVar (reference var_exception_, threaded_engine.h).
  std::shared_ptr<std::string> exception;
};

struct Opr {
  std::function<int(char *, size_t)> fn;  // returns 0 ok; fills err on -1
  std::vector<int64_t> const_vars;
  std::vector<int64_t> mutable_vars;
  std::atomic<int> wait{0};
  int priority = 0;
  uint64_t seq = 0;  // FIFO tiebreak within a priority class
  int64_t submit_us = 0;  // telemetry queue-wait span anchor (0 = untimed)
};

class Engine {
 public:
  Engine(int kind, int num_workers)
      : naive_(kind == 1),
        pool_(naive_ ? nullptr : new ThreadPool(num_workers)) {
    forkguard::RegisterEngine(this);
  }

  ~Engine() {
    forkguard::UnregisterEngine(this);
    WaitForAll();
    delete pool_;
  }

  // ---- fork protocol (forkguard below) ----
  void LockForFork() { mu_.lock(); }
  void UnlockForFork() { mu_.unlock(); }

  // Child-side: ops in flight at fork are LOST (their workers are gone,
  // their Complete() will never run) — reset the dependency state to
  // empty-but-usable, matching the reference's child-side engine
  // re-creation.  Var ids stay valid; versions/exec counts persist.
  void ResetAfterFork() {
    new (&mu_) std::mutex();
    new (&wait_cv_) std::condition_variable();
    for (auto &kv : vars_) {
      kv.second.queue.clear();
      kv.second.active_readers = 0;
      kv.second.writer_active = false;
      kv.second.exception.reset();
    }
    delete_marks_.clear();
    pending_ready_.clear();
    global_exception_.reset();
    num_pending_ = 0;
  }

  int64_t NewVariable() {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t id = next_var_++;
    vars_.emplace(id, Var());
    return id;
  }

  void DeleteVariable(int64_t var) {
    // Deletion must respect ordering: drop the var only after everything
    // already queued on it has run (reference Engine::DeleteVariable pushes
    // a deletion op).  Implemented as a write-op that marks it.
    PushAsync([](char *, size_t) { return 0; }, {}, {var}, 0, var);
  }

  void PushAsync(std::function<int(char *, size_t)> fn,
                 std::vector<int64_t> const_vars,
                 std::vector<int64_t> mutable_vars, int priority,
                 int64_t delete_var = -1) {
    const bool telem = telemetry::Enabled();
    if (telem) {
      static auto *c_disp = telemetry::GetCounter("engine.ops_dispatched");
      telemetry::CounterAdd(c_disp, 1);
    }
    if (naive_) {
      char err[1024] = {0};
      int64_t t0 = telem ? NowUs() : 0;
      int rc = fn(err, sizeof(err));
      if (telem) {
        static auto *h_run = telemetry::GetHist("engine.run_us");
        static auto *c_exec = telemetry::GetCounter("engine.ops_executed");
        telemetry::HistObserve(h_run, static_cast<double>(NowUs() - t0));
        telemetry::CounterAdd(c_exec, 1);
        if (rc != 0) {
          static auto *c_exc = telemetry::GetCounter("engine.exceptions");
          telemetry::CounterAdd(c_exc, 1);
        }
      }
      std::lock_guard<std::mutex> lk(mu_);
      ++num_executed_;
      if (rc != 0) {
        auto ex = std::make_shared<std::string>(err);
        global_exception_ = ex;
        for (int64_t v : mutable_vars) {
          auto it = vars_.find(v);
          if (it != vars_.end()) it->second.exception = ex;
        }
      }
      if (delete_var >= 0) vars_.erase(delete_var);
      return;
    }
    Opr *opr = new Opr();
    opr->fn = std::move(fn);
    opr->const_vars = std::move(const_vars);
    opr->mutable_vars = std::move(mutable_vars);
    opr->priority = priority;
    if (telem) opr->submit_us = NowUs();
    std::vector<Opr *> ready;
    {
      std::lock_guard<std::mutex> lk(mu_);
      opr->seq = next_seq_++;
      ++num_pending_;
      if (telem) {
        static auto *g_pend = telemetry::GetGauge("engine.pending_ops");
        telemetry::GaugeSet(g_pend, num_pending_);
      }
      if (delete_var >= 0) delete_marks_[opr] = delete_var;
      // One token per variable access; granted tokens decrement wait.
      opr->wait.store(
          static_cast<int>(opr->const_vars.size() + opr->mutable_vars.size()) +
          1);
      for (int64_t v : opr->const_vars) Append(v, opr, /*is_write=*/false);
      for (int64_t v : opr->mutable_vars) Append(v, opr, /*is_write=*/true);
      // The +1 sentinel token prevents dispatch before all appends finish.
      if (opr->wait.fetch_sub(1) == 1) ready.push_back(opr);
      for (Opr *o : pending_ready_) ready.push_back(o);
      pending_ready_.clear();
    }
    for (Opr *o : ready) Dispatch(o);
  }

  // Rethrow-at-wait: returns empty string on success, error text on failure.
  std::string WaitForVar(int64_t var) {
    std::unique_lock<std::mutex> lk(mu_);
    wait_cv_.wait(lk, [this, var] {
      auto it = vars_.find(var);
      if (it == vars_.end()) return true;
      return it->second.queue.empty() && it->second.active_readers == 0 &&
             !it->second.writer_active;
    });
    auto it = vars_.find(var);
    if (it != vars_.end() && it->second.exception) {
      std::string msg = *it->second.exception;
      it->second.exception.reset();  // rethrown once, like the reference
      return msg;
    }
    return "";
  }

  std::string WaitForAll() {
    std::unique_lock<std::mutex> lk(mu_);
    wait_cv_.wait(lk, [this] { return num_pending_ == 0; });
    if (global_exception_) {
      std::string msg = *global_exception_;
      global_exception_.reset();
      return msg;
    }
    return "";
  }

  int64_t NumExecuted() {
    std::lock_guard<std::mutex> lk(mu_);
    return num_executed_;
  }

  // Queue-state line for the telemetry snapshot / diagnostic dumps
  // (SnapshotJson embeds one per live engine via forkguard).
  std::string StateJson() {
    std::lock_guard<std::mutex> lk(mu_);
    std::string s = "{\"naive\": ";
    s += naive_ ? "true" : "false";
    s += ", \"workers\": " +
         std::to_string(pool_ ? pool_->size() : 0);
    s += ", \"pending\": " + std::to_string(num_pending_);
    s += ", \"executed\": " + std::to_string(num_executed_);
    s += ", \"vars\": " + std::to_string(vars_.size());
    s += ", \"has_exception\": ";
    s += global_exception_ ? "true" : "false";
    s += "}";
    return s;
  }

 private:
  // mu_ held.
  void Append(int64_t vid, Opr *opr, bool is_write) {
    Var &v = vars_[vid];
    v.queue.push_back({opr, is_write});
    GrantLocked(vid, v);
  }

  // Grant queued accesses from the head while the access rules allow
  // (reference ThreadedVar::CompleteReadDependency/CompleteWriteDependency
  // grant chain, threaded_engine.h:155-166).  mu_ held; ready ops collected
  // into ready_ and dispatched by the caller of Complete/Push.
  void GrantLocked(int64_t vid, Var &v) {
    while (!v.queue.empty()) {
      Var::Pending &head = v.queue.front();
      if (head.is_write) {
        if (v.active_readers > 0 || v.writer_active) break;
        v.writer_active = true;
        Opr *o = head.opr;
        v.queue.pop_front();
        if (o->wait.fetch_sub(1) == 1) pending_ready_.push_back(o);
        break;  // a writer blocks everything behind it
      } else {
        if (v.writer_active) break;
        ++v.active_readers;
        Opr *o = head.opr;
        v.queue.pop_front();
        if (o->wait.fetch_sub(1) == 1) pending_ready_.push_back(o);
      }
    }
    (void)vid;
  }

  void Dispatch(Opr *opr) {
    pool_->Submit([this, opr] { this->Execute(opr); }, opr->priority);
  }

  void Execute(Opr *opr) {
    char err[1024] = {0};
    int rc = 0;
    const bool telem = telemetry::Enabled();
    if (telem && opr->submit_us > 0) {
      static auto *h_queue = telemetry::GetHist("engine.queue_wait_us");
      telemetry::HistObserve(h_queue,
                             static_cast<double>(NowUs() - opr->submit_us));
    }
    int64_t t0 = telem ? NowUs() : 0;
    try {
      rc = opr->fn(err, sizeof(err));
    } catch (const std::exception &e) {
      rc = -1;
      std::strncpy(err, e.what(), sizeof(err) - 1);
    } catch (...) {
      rc = -1;
      std::strncpy(err, "unknown C++ exception in engine op", sizeof(err) - 1);
    }
    if (telem) {
      static auto *h_run = telemetry::GetHist("engine.run_us");
      static auto *c_exec = telemetry::GetCounter("engine.ops_executed");
      telemetry::HistObserve(h_run, static_cast<double>(NowUs() - t0));
      telemetry::CounterAdd(c_exec, 1);
      if (rc != 0) {
        static auto *c_exc = telemetry::GetCounter("engine.exceptions");
        telemetry::CounterAdd(c_exc, 1);
      }
    }
    std::vector<Opr *> ready;
    {
      std::lock_guard<std::mutex> lk(mu_);
      ++num_executed_;
      std::shared_ptr<std::string> ex;
      if (rc != 0) {
        ex = std::make_shared<std::string>(err);
        global_exception_ = ex;
      }
      for (int64_t vid : opr->const_vars) {
        auto it = vars_.find(vid);
        if (it == vars_.end()) continue;
        --it->second.active_readers;
        GrantLocked(vid, it->second);
      }
      for (int64_t vid : opr->mutable_vars) {
        auto it = vars_.find(vid);
        if (it == vars_.end()) continue;
        it->second.writer_active = false;
        ++it->second.version;
        if (ex) it->second.exception = ex;
        GrantLocked(vid, it->second);
      }
      auto dm = delete_marks_.find(opr);
      if (dm != delete_marks_.end()) {
        vars_.erase(dm->second);
        delete_marks_.erase(dm);
      }
      --num_pending_;
      if (telem) {
        static auto *g_pend = telemetry::GetGauge("engine.pending_ops");
        telemetry::GaugeSet(g_pend, num_pending_);
      }
      ready.swap(pending_ready_);
    }
    wait_cv_.notify_all();
    delete opr;
    for (Opr *o : ready) Dispatch(o);
  }

  std::mutex mu_;
  std::condition_variable wait_cv_;
  std::unordered_map<int64_t, Var> vars_;
  std::unordered_map<Opr *, int64_t> delete_marks_;
  std::vector<Opr *> pending_ready_;
  std::shared_ptr<std::string> global_exception_;
  int64_t next_var_ = 1;
  uint64_t next_seq_ = 0;
  int64_t num_pending_ = 0;
  int64_t num_executed_ = 0;
  bool naive_;
  ThreadPool *pool_;
};

// ---- forkguard: the combined atfork protocol over engines + pools ----
// prepare: lock the registry, every engine's mu_, every pool's mu_ —
//   the child then inherits CONSISTENT dependency/queue state (no thread
//   can be mid-Submit or mid-Append at the fork point).  Lock ordering
//   is safe: no code path holds an engine or pool mutex while acquiring
//   another (Dispatch/Complete call into the pool outside engine locks).
// parent: unlock everything in reverse.
// child: rebuild the (locked-at-fork) mutexes, reset engines, re-spawn
//   pools over empty queues.
namespace forkguard {
namespace {
std::mutex &Mutex() {
  static std::mutex m;
  return m;
}
std::set<Engine *> &Engines() {
  static std::set<Engine *> s;
  return s;
}
std::set<ThreadPool *> &Pools() {
  static std::set<ThreadPool *> s;
  return s;
}
void Prepare() {
  Mutex().lock();
  for (Engine *e : Engines()) e->LockForFork();
  for (ThreadPool *p : Pools()) p->LockForFork();
}
void Parent() {
  for (ThreadPool *p : Pools()) p->UnlockForFork();
  for (Engine *e : Engines()) e->UnlockForFork();
  Mutex().unlock();
}
void Child() {
  new (&Mutex()) std::mutex();
  for (Engine *e : Engines()) e->ResetAfterFork();
  for (ThreadPool *p : Pools()) p->ReinitAfterFork();
}
void InstallOnce() {
  static bool done = [] {
    ::pthread_atfork(Prepare, Parent, Child);
    return true;
  }();
  (void)done;
}
}  // namespace

void RegisterPool(ThreadPool *p) {
  InstallOnce();
  std::lock_guard<std::mutex> lk(Mutex());
  Pools().insert(p);
}

void UnregisterPool(ThreadPool *p) {
  std::lock_guard<std::mutex> lk(Mutex());
  Pools().erase(p);
}

void RegisterEngine(Engine *e) {
  InstallOnce();
  std::lock_guard<std::mutex> lk(Mutex());
  Engines().insert(e);
}

void UnregisterEngine(Engine *e) {
  std::lock_guard<std::mutex> lk(Mutex());
  Engines().erase(e);
}

// Live queue state of every registered engine, for MXTTelemetrySnapshot.
// Lock order (registry mutex, then each engine's mu_) matches Prepare().
std::string EnginesStateJson() {
  std::lock_guard<std::mutex> lk(Mutex());
  std::string out = "[";
  bool first = true;
  for (Engine *e : Engines()) {
    if (!first) out += ", ";
    first = false;
    out += e->StateJson();
  }
  out += "]";
  return out;
}
}  // namespace forkguard

}  // namespace mxt

// ----------------------------------------------------------------- C API ---
using mxt::Engine;
using mxt::SetLastError;
using mxt::ThreadPool;

#define API_BEGIN() try {
#define API_END()                         \
  }                                       \
  catch (const std::exception &e) {       \
    SetLastError(e.what());               \
    return -1;                            \
  }                                       \
  catch (...) {                           \
    SetLastError("unknown C++ exception");\
    return -1;                            \
  }                                       \
  return 0;

extern "C" {

const char *MXTGetLastError(void) { return mxt::g_last_error.c_str(); }

int MXTEngineCreate(int kind, int num_workers, EngineHandle *out) {
  API_BEGIN();
  *out = new Engine(kind, num_workers);
  API_END();
}

int MXTEngineFree(EngineHandle h) {
  API_BEGIN();
  delete static_cast<Engine *>(h);
  API_END();
}

int MXTEngineNewVariable(EngineHandle h, VarHandle *out) {
  API_BEGIN();
  *out = static_cast<Engine *>(h)->NewVariable();
  API_END();
}

int MXTEngineDeleteVariable(EngineHandle h, VarHandle var) {
  API_BEGIN();
  static_cast<Engine *>(h)->DeleteVariable(var);
  API_END();
}

int MXTEnginePushAsync(EngineHandle h, MXTOpFunc fn, void *payload,
                       MXTOpDeleter del, const VarHandle *const_vars,
                       int n_const, const VarHandle *mutable_vars,
                       int n_mutable, int priority) {
  API_BEGIN();
  std::vector<int64_t> cv(const_vars, const_vars + n_const);
  std::vector<int64_t> mv(mutable_vars, mutable_vars + n_mutable);
  auto body = [fn, payload, del](char *err, size_t err_len) -> int {
    int rc = fn(payload, err, err_len);
    if (del) del(payload);
    return rc;
  };
  static_cast<Engine *>(h)->PushAsync(body, std::move(cv), std::move(mv),
                                      priority);
  API_END();
}

int MXTEngineWaitForVar(EngineHandle h, VarHandle var) {
  API_BEGIN();
  std::string msg = static_cast<Engine *>(h)->WaitForVar(var);
  if (!msg.empty()) {
    SetLastError(msg);
    return -1;
  }
  API_END();
}

int MXTEngineWaitForAll(EngineHandle h) {
  API_BEGIN();
  std::string msg = static_cast<Engine *>(h)->WaitForAll();
  if (!msg.empty()) {
    SetLastError(msg);
    return -1;
  }
  API_END();
}

int MXTEngineNumExecuted(EngineHandle h, int64_t *out) {
  API_BEGIN();
  *out = static_cast<Engine *>(h)->NumExecuted();
  API_END();
}

int MXTThreadPoolCreate(int num_workers, ThreadPoolHandle *out) {
  API_BEGIN();
  *out = new ThreadPool(num_workers);
  API_END();
}

int MXTThreadPoolFree(ThreadPoolHandle h) {
  API_BEGIN();
  delete static_cast<ThreadPool *>(h);
  API_END();
}

int MXTThreadPoolSubmit(ThreadPoolHandle h, MXTOpFunc fn, void *payload,
                        MXTOpDeleter del) {
  API_BEGIN();
  static_cast<ThreadPool *>(h)->Submit([fn, payload, del] {
    char err[256];
    fn(payload, err, sizeof(err));
    if (del) del(payload);
  });
  API_END();
}

int MXTThreadPoolWaitAll(ThreadPoolHandle h) {
  API_BEGIN();
  static_cast<ThreadPool *>(h)->WaitAll();
  API_END();
}

}  // extern "C"

// ------------------------------------------------------- the counter block
namespace mxt {
namespace telemetry {

std::atomic<bool> g_enabled{true};

struct CounterSlot {
  std::atomic<int64_t> v{0};
};
struct GaugeSlot {
  std::atomic<int64_t> v{0};
};
struct HistSlot {
  std::mutex mu;
  int64_t counts[kNumBuckets] = {0};
  int64_t count = 0;
  double sum = 0.0;
};

namespace {
std::mutex &RegMutex() {
  static std::mutex m;
  return m;
}
template <typename T>
std::map<std::string, T *> &Slots() {
  static std::map<std::string, T *> m;
  return m;
}
template <typename T>
T *GetSlot(const char *name) {
  std::lock_guard<std::mutex> lk(RegMutex());
  auto &m = Slots<T>();
  auto it = m.find(name);
  if (it != m.end()) return it->second;
  T *s = new T();
  m.emplace(name, s);
  return s;
}
void AppendName(std::string *out, const std::string &name) {
  *out += "\"";
  for (char c : name) {
    if (c == '"' || c == '\\') *out += '\\';
    *out += c;
  }
  *out += "\"";
}
}  // namespace

CounterSlot *GetCounter(const char *name) {
  return GetSlot<CounterSlot>(name);
}
GaugeSlot *GetGauge(const char *name) { return GetSlot<GaugeSlot>(name); }
HistSlot *GetHist(const char *name) { return GetSlot<HistSlot>(name); }

void CounterAdd(CounterSlot *c, int64_t delta) {
  c->v.fetch_add(delta, std::memory_order_relaxed);
}

void GaugeSet(GaugeSlot *g, int64_t v) {
  g->v.store(v, std::memory_order_relaxed);
}

void HistObserve(HistSlot *h, double value_us) {
  int b = kNumBounds;
  for (int i = 0; i < kNumBounds; ++i) {
    if (value_us <= kBucketBoundsUs[i]) {
      b = i;
      break;
    }
  }
  std::lock_guard<std::mutex> lk(h->mu);
  ++h->counts[b];
  ++h->count;
  h->sum += value_us;
}

std::string SlotsJson() {
  std::lock_guard<std::mutex> lk(RegMutex());
  std::string out = "\"counters\": {";
  bool first = true;
  for (auto &kv : Slots<CounterSlot>()) {
    if (!first) out += ", ";
    first = false;
    AppendName(&out, kv.first);
    out += ": " + std::to_string(kv.second->v.load());
  }
  out += "}, \"gauges\": {";
  first = true;
  for (auto &kv : Slots<GaugeSlot>()) {
    if (!first) out += ", ";
    first = false;
    AppendName(&out, kv.first);
    out += ": " + std::to_string(kv.second->v.load());
  }
  out += "}, \"histograms\": {";
  first = true;
  char num[64];
  for (auto &kv : Slots<HistSlot>()) {
    if (!first) out += ", ";
    first = false;
    AppendName(&out, kv.first);
    HistSlot *h = kv.second;
    std::lock_guard<std::mutex> hl(h->mu);
    out += ": {\"counts\": [";
    for (int i = 0; i < kNumBuckets; ++i) {
      if (i) out += ", ";
      out += std::to_string(h->counts[i]);
    }
    std::snprintf(num, sizeof(num), "%.17g", h->sum);
    out += "], \"count\": " + std::to_string(h->count) +
           ", \"sum\": " + num + "}";
  }
  out += "}";
  return out;
}

}  // namespace telemetry

namespace forkguard {
std::string EnginesStateJson();
}  // namespace forkguard
}  // namespace mxt

extern "C" {

int MXTEngineStatsEnable(int on, int *prev) {
  API_BEGIN();
  bool was = mxt::telemetry::g_enabled.exchange(on != 0);
  if (prev) *prev = was ? 1 : 0;
  API_END();
}

int MXTEngineStatsJson(char *buf, size_t len, size_t *need) {
  API_BEGIN();
  std::string s = "{" + mxt::telemetry::SlotsJson() +
                  ", \"engines\": " + mxt::forkguard::EnginesStateJson() +
                  "}";
  if (need) *need = s.size() + 1;
  if (buf && len >= s.size() + 1) std::memcpy(buf, s.c_str(), s.size() + 1);
  API_END();
}

}  // extern "C"
