/*
 * C predict API of the PyTorch/CUDA port: the same declarations as
 * include/mxnet_tpu/c_predict_api.h at the repository's root (parity:
 * reference include/mxnet/c_predict_api.h, the stable small inference
 * surface that amalgamation/mobile builds ship).  dev_type 1 is the host,
 * 2 the card.
 *
 * Flow: MXPredCreate(symbol json, params blob) -> MXPredSetInput ->
 * MXPredForward -> MXPredGetOutputShape -> MXPredGetOutput -> MXPredFree.
 * Tensor data crosses as float32.
 */
#ifndef MXNET_TPU_C_PREDICT_API_H_
#define MXNET_TPU_C_PREDICT_API_H_

#ifdef __cplusplus
extern "C" {
#endif

#include <stddef.h>
#include <stdint.h>

#ifndef MXNET_DLL
#define MXNET_DLL __attribute__((visibility("default")))
#endif

typedef unsigned int mx_uint;
typedef float mx_float;
typedef void *PredictorHandle;
typedef void *NDListHandle;

MXNET_DLL int MXPredCreate(const char *symbol_json_str,
                           const void *param_bytes, int param_size,
                           int dev_type, int dev_id,
                           mx_uint num_input_nodes,
                           const char **input_keys,
                           const mx_uint *input_shape_indptr,
                           const mx_uint *input_shape_data,
                           PredictorHandle *out);
/*! \brief feature-extraction binding: the predictor's outputs become the
 *  named internal node outputs (parity: c_predict_api.h:92) */
MXNET_DLL int MXPredCreatePartialOut(const char *symbol_json_str,
                                     const void *param_bytes, int param_size,
                                     int dev_type, int dev_id,
                                     mx_uint num_input_nodes,
                                     const char **input_keys,
                                     const mx_uint *input_shape_indptr,
                                     const mx_uint *input_shape_data,
                                     mx_uint num_output_nodes,
                                     const char **output_keys,
                                     PredictorHandle *out);
MXNET_DLL int MXPredSetInput(PredictorHandle handle, const char *key,
                             const mx_float *data, mx_uint size);
/*! \brief stepwise-forward protocol (parity: c_predict_api.h:150).  The
 *  whole forward runs on the first call; the calls count the graph's
 *  operator nodes down, so a `while (step_left > 0)` loop ends with the
 *  outputs ready. */
MXNET_DLL int MXPredPartialForward(PredictorHandle handle, int step,
                                   int *step_left);
MXNET_DLL int MXPredForward(PredictorHandle handle);
MXNET_DLL int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                                   mx_uint **shape_data, mx_uint *shape_ndim);
MXNET_DLL int MXPredGetOutput(PredictorHandle handle, mx_uint index,
                              mx_float *data, mx_uint size);
MXNET_DLL int MXPredFree(PredictorHandle handle);

/*! \brief load an in-memory .params blob as an indexable list (parity:
 *  c_predict_api.h:180-214 — the mean-image loader) */
MXNET_DLL int MXNDListCreate(const char *nd_file_bytes, int nd_file_size,
                             NDListHandle *out, mx_uint *out_length);
MXNET_DLL int MXNDListGet(NDListHandle handle, mx_uint index,
                          const char **out_key, const mx_float **out_data,
                          const mx_uint **out_shape, mx_uint *out_ndim);
MXNET_DLL int MXNDListFree(NDListHandle handle);

#ifdef __cplusplus
}
#endif

#endif  /* MXNET_TPU_C_PREDICT_API_H_ */
