/* C API for the PyTorch/CUDA port's visual odometry (bpvo_tpu_torch): the
 * five functions and signatures of the JAX package's C API
 * (native/bpvo_vo_capi.h), the foreign-binding analogue of the reference's
 * MATLAB mex handle interface, plus bpvo_vo_create_on, which names the
 * device.  See bpvo_torch_capi.cc for semantics; vo_c_example.c for usage.
 * Built by bpvo_tpu_torch/capi/build.py. */
#ifndef BPVO_TORCH_CAPI_H_
#define BPVO_TORCH_CAPI_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef struct Vo bpvo_vo_t;

/* K9 = row-major 3x3 intrinsics; config_path NULL for defaults or a
 * reference-format `Key = Value` file.  Runs on the CUDA device.  NULL on
 * error. */
bpvo_vo_t* bpvo_vo_create(const float* K9, float baseline, int rows, int cols,
                          const char* config_path);

/* As bpvo_vo_create, on `device` ("cuda", "cuda:1", or "cpu" for the plain
 * versions). */
bpvo_vo_t* bpvo_vo_create_on(const float* K9, float baseline, int rows,
                             int cols, const char* config_path,
                             const char* device);

/* image/disparity: row-major float32 [rows*cols], copied before the call
 * returns, so the caller may reuse them; pose_out: row-major 4x4 relative
 * motion wrt the previous frame (may be NULL); is_keyframe may be NULL.
 * 0 on success, -1 on error. */
int bpvo_vo_add_frame(bpvo_vo_t* h, const float* image,
                      const float* disparity, float* pose_out,
                      int* is_keyframe);

int bpvo_vo_trajectory_size(bpvo_vo_t* h);
void bpvo_vo_destroy(bpvo_vo_t* h);
const char* bpvo_vo_last_error(void);

#ifdef __cplusplus
}
#endif
#endif /* BPVO_TORCH_CAPI_H_ */
