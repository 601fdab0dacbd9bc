// Native data-loader hot path of theanompi_tpu_torch.
//
// A copy of theanompi_tpu/native/loader.cc (the port imports nothing of the
// JAX package): the fused host pass of the ImageNet input path.  One call
// crops, mirrors, subtracts the mean, casts uint8 to float32 and, for bc01
// ("NCHW", the reference's batch-file layout) input, transposes to NHWC,
// for a whole batch, split over threads.  At AlexNet's batch of 128 that is
// ~19.8M uint8 reads and 79 MB of float32 writes per step per rank.
//
// Exposed as a plain C ABI (ABI version 1, the JAX package's) and called
// through ctypes, which releases the GIL for the call: the pooled producer
// of models/data/prefetch.py runs several of these at once.  Output is NHWC
// float32, the layout of the port's activations.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 loader.cc -o <lib>.so
// (driven by theanompi_tpu_torch/native/__init__.py into build/native/).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct AugmentArgs {
  const uint8_t* in;   // [n,h,w,c] or [n,c,h,w]
  float* out;          // [n,crop,crop,c]
  int n, h, w, c, crop;
  int in_nchw;         // input layout: 0 = NHWC, 1 = NCHW
  const int* oy;       // per-image crop offsets [n]
  const int* ox;       // [n]
  const uint8_t* flip; // per-image horizontal mirror [n]
  const float* mean;   // nullptr, or [crop,crop,c] (pre-cropped mean image)
  float mean_scalar;   // used when mean == nullptr
};

// One image: fused crop + mirror + mean-subtract + cast (+ transpose).
void augment_one(const AugmentArgs& a, int i) {
  const int h = a.h, w = a.w, c = a.c, crop = a.crop;
  const int oy = a.oy[i], ox = a.ox[i];
  const bool flip = a.flip[i] != 0;
  float* dst = a.out + (size_t)i * crop * crop * c;

  if (!a.in_nchw) {
    const uint8_t* src = a.in + (size_t)i * h * w * c;
    for (int y = 0; y < crop; ++y) {
      const uint8_t* row = src + ((size_t)(y + oy) * w + ox) * c;
      float* drow = dst + (size_t)y * crop * c;
      const float* mrow = a.mean ? a.mean + (size_t)y * crop * c : nullptr;
      if (!flip) {
        if (mrow) {
          for (int x = 0; x < crop * c; ++x) drow[x] = (float)row[x] - mrow[x];
        } else {
          const float m = a.mean_scalar;
          for (int x = 0; x < crop * c; ++x) drow[x] = (float)row[x] - m;
        }
      } else {
        // mirror: output x reads input (crop-1-x); mean indexed by OUTPUT x
        for (int x = 0; x < crop; ++x) {
          const uint8_t* px = row + (size_t)(crop - 1 - x) * c;
          float* dpx = drow + (size_t)x * c;
          if (mrow) {
            const float* mpx = mrow + (size_t)x * c;
            for (int k = 0; k < c; ++k) dpx[k] = (float)px[k] - mpx[k];
          } else {
            for (int k = 0; k < c; ++k) dpx[k] = (float)px[k] - a.mean_scalar;
          }
        }
      }
    }
  } else {
    // NCHW input: gather channel planes, write NHWC.
    const uint8_t* src = a.in + (size_t)i * c * h * w;
    for (int y = 0; y < crop; ++y) {
      float* drow = dst + (size_t)y * crop * c;
      const float* mrow = a.mean ? a.mean + (size_t)y * crop * c : nullptr;
      for (int x = 0; x < crop; ++x) {
        const int sx = flip ? (ox + crop - 1 - x) : (ox + x);
        const size_t plane_off = (size_t)(y + oy) * w + sx;
        float* dpx = drow + (size_t)x * c;
        for (int k = 0; k < c; ++k) {
          const float m = mrow ? mrow[(size_t)x * c + k] : a.mean_scalar;
          dpx[k] = (float)src[(size_t)k * h * w + plane_off] - m;
        }
      }
    }
  }
}

void run_range(const AugmentArgs& a, int lo, int hi) {
  for (int i = lo; i < hi; ++i) augment_one(a, i);
}

}  // namespace

extern "C" {

// Fused batch augmentation.  in: uint8 [n,h,w,c] (in_nchw=0) or [n,c,h,w]
// (in_nchw=1); out: float32 [n,crop,crop,c]; oy/ox/flip: per-image params
// [n]; mean: nullptr (use mean_scalar) or float32 [crop,crop,c] already
// cropped to the output window.  n_threads<=1 runs inline.
void tmpi_augment_u8(const uint8_t* in, float* out, int n, int h, int w,
                     int c, int crop, int in_nchw, const int* oy,
                     const int* ox, const uint8_t* flip, const float* mean,
                     float mean_scalar, int n_threads) {
  AugmentArgs a{in, out, n, h, w, c, crop, in_nchw, oy, ox, flip,
                mean, mean_scalar};
  if (n_threads <= 1 || n <= 1) {
    run_range(a, 0, n);
    return;
  }
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  const int per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int lo = t * per;
    const int hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    ts.emplace_back([&a, lo, hi] { run_range(a, lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// Version stamp so the Python side can cache-bust compiled objects.
int tmpi_loader_abi_version() { return 1; }

}  // extern "C"
