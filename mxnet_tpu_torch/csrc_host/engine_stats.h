/*!
 * The engine's counter block: counters, gauges and latency histograms by
 * name, kept in the library and read whole by MXTEngineStatsJson, which
 * the Python telemetry registry folds in under the same names.  The
 * interface is the runtime registry's that the JAX package's engine
 * counts into (Enabled / GetCounter / CounterAdd / GaugeSet /
 * HistObserve), so engine.cc counts as that engine does.
 *
 * Slots live for the process lifetime (never freed), so the engine's
 * cached static pointers stay valid.
 */
#ifndef MXT_ENGINE_STATS_H_
#define MXT_ENGINE_STATS_H_

#include <atomic>
#include <cstdint>
#include <string>

namespace mxt {
namespace telemetry {

/* Latency bucket upper bounds in MICROSECONDS; one overflow (+inf)
 * bucket follows.  mxnet_tpu_torch/telemetry.py's BUCKET_BOUNDS_US is
 * the same list. */
constexpr double kBucketBoundsUs[] = {
    1,    2,    5,     10,    25,    50,     100,    250,     500,
    1000, 2500, 5000,  10000, 25000, 50000,  100000, 250000,  1000000};
constexpr int kNumBounds =
    static_cast<int>(sizeof(kBucketBoundsUs) / sizeof(kBucketBoundsUs[0]));
constexpr int kNumBuckets = kNumBounds + 1; /* + overflow */

struct CounterSlot;
struct GaugeSlot;
struct HistSlot;

extern std::atomic<bool> g_enabled;

inline bool Enabled() { return g_enabled.load(std::memory_order_relaxed); }

CounterSlot *GetCounter(const char *name);
GaugeSlot *GetGauge(const char *name);
HistSlot *GetHist(const char *name);

void CounterAdd(CounterSlot *c, int64_t delta);
void GaugeSet(GaugeSlot *g, int64_t v);
void HistObserve(HistSlot *h, double value_us);

/* Every slot as the JSON maps of MXTEngineStatsJson (without
 * "engines"): `"counters": {...}, "gauges": {...}, "histograms": {...}`. */
std::string SlotsJson();

}  // namespace telemetry
}  // namespace mxt

#endif  // MXT_ENGINE_STATS_H_
