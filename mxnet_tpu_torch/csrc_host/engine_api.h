/*!
 * The native engine's flat C ABI: the port's copy of the engine part of
 * the JAX package's runtime C API header (its c_api.h), with the
 * engine's counter block in place of the runtime's telemetry registry.
 *
 * Error contract: every function returns 0 on success, -1 on failure;
 * the failure message is retrievable per thread via MXTGetLastError.
 */
#ifndef MXT_ENGINE_API_H_
#define MXT_ENGINE_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void *EngineHandle;
typedef int64_t VarHandle;
typedef void *ThreadPoolHandle;

/* Async op body: user payload, returns 0 ok / -1 error (error text
 * written into err_buf, err_len bytes). */
typedef int (*MXTOpFunc)(void *payload, char *err_buf, size_t err_len);
/* Deleter for the payload, called after the op runs. */
typedef void (*MXTOpDeleter)(void *payload);

const char *MXTGetLastError(void);

/* ---------------- engine ---------------- */
/* kind: 0 = threaded (default), 1 = naive (synchronous, deterministic:
 * MXNET_ENGINE_TYPE=NaiveEngine). */
int MXTEngineCreate(int kind, int num_workers, EngineHandle *out);
int MXTEngineFree(EngineHandle h);
int MXTEngineNewVariable(EngineHandle h, VarHandle *out);
/* Delete var once all pending ops on it complete. */
int MXTEngineDeleteVariable(EngineHandle h, VarHandle var);
/* Push async op reading const_vars and writing mutable_vars. */
int MXTEnginePushAsync(EngineHandle h, MXTOpFunc fn, void *payload,
                       MXTOpDeleter del, const VarHandle *const_vars,
                       int n_const, const VarHandle *mutable_vars,
                       int n_mutable, int priority);
/* Block until every op involving var has completed; returns -1 with the
 * message if an op writing this var failed (rethrown once). */
int MXTEngineWaitForVar(EngineHandle h, VarHandle var);
int MXTEngineWaitForAll(EngineHandle h);
int MXTEngineNumExecuted(EngineHandle h, int64_t *out);

/* ---------------- thread pool ---------------- */
int MXTThreadPoolCreate(int num_workers, ThreadPoolHandle *out);
int MXTThreadPoolFree(ThreadPoolHandle h);
int MXTThreadPoolSubmit(ThreadPoolHandle h, MXTOpFunc fn, void *payload,
                        MXTOpDeleter del);
int MXTThreadPoolWaitAll(ThreadPoolHandle h);

/* ---------------- the engine's counters ---------------- */
/* Recording on (1) or off (0); *prev gets the former flag. */
int MXTEngineStatsEnable(int on, int *prev);
/* The counters, gauges and histograms the engine recorded, and every
 * live engine's queue state, as one JSON object:
 *   {"counters": {name: n}, "gauges": {name: n},
 *    "histograms": {name: {"counts": [...], "count": n, "sum": x}},
 *    "engines": [{"naive", "workers", "pending", "executed", "vars",
 *                 "has_exception"}, ...]}
 * Written into buf (NUL-terminated) when it fits in len bytes; *need
 * gets the bytes the text takes with its NUL either way. */
int MXTEngineStatsJson(char *buf, size_t len, size_t *need);

#ifdef __cplusplus
}
#endif

#endif  /* MXT_ENGINE_API_H_ */
