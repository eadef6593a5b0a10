// The assign kernels' running verdict over prototypes taken in order:
// the argmax moves only on strict '>', so the first index wins; dead
// prototypes (-inf) never move it.
#pragma once

#include <math.h>

struct Verdict {
  float best = -INFINITY;
  float second = -INFINITY;
  int arg = 0;
  __device__ __forceinline__ void take(float a, int t) {
    if (a > best) {
      second = best;
      best = a;
      arg = t;
    } else if (a > second) {
      second = a;
    }
  }
  // Another verdict over other prototypes: the lower index wins on equal
  // values, as it would taking all of them in order.
  __device__ __forceinline__ void merge(float ob, float os, int oa) {
    if (ob > best || (ob == best && oa < arg)) {
      second = fmaxf(best, os);
      best = ob;
      arg = oa;
    } else {
      second = fmaxf(second, ob);
    }
  }
  // T == 1 has no runner-up: the margin is the affinity itself.  All
  // prototypes dead gives -inf - -inf = NaN, one live among several +inf.
  __device__ __forceinline__ float margin(int n_protos) const {
    return n_protos == 1 ? best : best - second;
  }
};
