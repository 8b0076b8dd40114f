/* Minimal C host embedding the PyTorch/CUDA port's visual odometry through
 * its C API (counterpart of native/vo_c_example.c; the usage shape of the
 * reference's vo_example.cc crossed with its MATLAB mex embedding).  Feeds
 * synthetic translating frames, reusing one image and one disparity buffer
 * for every frame, and prints the recovered per-frame translation.
 *
 *   vo_c_example [cpu]
 *
 * Runs on the CUDA device unless given `cpu`.  Built by
 * bpvo_tpu_torch/capi/build.py; run it with the Python environment's
 * site-packages and the repository root on PYTHONPATH.
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "bpvo_torch_capi.h"

#define ROWS 120
#define COLS 160

static float texture(double x, double y) {
  return (float)(128.0 + 60.0 * sin(x / 7.0) * cos(y / 9.0) +
                 40.0 * sin((x + 2.0 * y) / 13.0));
}

int main(int argc, char** argv) {
  const char* device = (argc > 1 && strcmp(argv[1], "cpu") == 0) ? "cpu"
                                                                 : "cuda";
  const float fx = 0.8f * COLS;
  const float K[9] = {fx, 0, COLS / 2.0f, 0, fx, ROWS / 2.0f, 0, 0, 1};
  const float baseline = 0.12f;
  const double z = 8.0;             /* fronto-parallel plane depth */
  const double tx_per_frame = 0.02; /* lateral motion, world units */

  bpvo_vo_t* vo = bpvo_vo_create_on(K, baseline, ROWS, COLS, NULL, device);
  if (!vo) {
    fprintf(stderr, "create failed: %s\n", bpvo_vo_last_error());
    return 1;
  }

  float* img = malloc(sizeof(float) * ROWS * COLS);
  float* dsp = malloc(sizeof(float) * ROWS * COLS);
  float pose[16];
  int kf = 0, ok = 0;
  for (int f = 0; f < 4; ++f) {
    /* camera moving +x: the plane's texture shifts by fx*tx/z pixels */
    double shift = fx * (f * tx_per_frame) / z;
    for (int r = 0; r < ROWS; ++r)
      for (int c = 0; c < COLS; ++c) {
        img[r * COLS + c] = texture(c + shift, r);
        dsp[r * COLS + c] = fx * baseline / z;
      }
    if (bpvo_vo_add_frame(vo, img, dsp, pose, &kf) != 0) {
      fprintf(stderr, "add_frame failed: %s\n", bpvo_vo_last_error());
      return 1;
    }
    printf("frame %d: t = [%+.4f %+.4f %+.4f] keyframe=%d\n", f, pose[3],
           pose[7], pose[11], kf);
    if (f > 0 && fabs(pose[3] - (-tx_per_frame)) < 5e-3) ok++;
  }
  int n = bpvo_vo_trajectory_size(vo);
  printf("trajectory frames: %d\n", n);
  bpvo_vo_destroy(vo);
  free(img);
  free(dsp);
  if (ok < 3 || n != 4) {
    fprintf(stderr, "FAIL: recovered motion wrong (ok=%d n=%d)\n", ok, n);
    return 1;
  }
  printf("C-API example (%s): OK\n", device);
  return 0;
}
