/*
 * C API of the PyTorch/CUDA port (mxnet_tpu_torch): the same declarations
 * as include/mxnet_tpu/c_api.h at the repository's root, under the same
 * include path, so C and C++ programs (the cpp-package) build against
 * either library unchanged.  Implementation: mxnet_tpu_torch/csrc/c_api.cc
 * embeds CPython and calls mxnet_tpu_torch.capi; the compute underneath is
 * PyTorch on the card, as the Python frontend uses it.
 *
 * Conventions (MXNet's):
 *  - every function returns 0 on success, -1 on failure;
 *  - MXGetLastError() returns the failure message for this thread;
 *  - handles must be freed with their MX*Free function;
 *  - device type codes: 1 cpu, 2 gpu, 3 cpu_pinned; any other code fails.
 */
#ifndef MXNET_TPU_C_API_H_
#define MXNET_TPU_C_API_H_

#ifdef __cplusplus
extern "C" {
#endif

#include <stddef.h>
#include <stdint.h>

#define MXNET_DLL __attribute__((visibility("default")))

typedef unsigned int mx_uint;
typedef float mx_float;
typedef void *NDArrayHandle;
typedef void *SymbolHandle;
typedef void *ExecutorHandle;
typedef void *KVStoreHandle;
typedef void *DataIterHandle;
typedef void *AtomicSymbolCreator;
typedef void *DataIterCreator;

/*! \brief user-defined gradient updater installed on a KVStore
 *  (parity: reference include/mxnet/c_api.h MXKVStoreUpdater) */
typedef void (*MXKVStoreUpdater)(int key, NDArrayHandle recv,
                                 NDArrayHandle local, void *handle);

/*! \brief per-op monitor callback (parity: reference c_api.h:68
 *  ExecutorMonitorCallback).  Receives the op-output name and an OWNED
 *  NDArray handle the callback must free with MXNDArrayFree. */
typedef void (*ExecutorMonitorCallback)(const char *name,
                                        NDArrayHandle arr, void *handle);

/*! \brief C custom-operator callback tables (parity: reference
 *  c_api.h:103-140 CustomOpInfo/CustomOpPropInfo/CustomOpPropCreator;
 *  tags: 0 in_data, 1 out_data, 2 in_grad, 3 out_grad, 4 aux). */
struct CustomOpInfo {
  bool (*forward)(int /*size*/, void ** /*ptrs*/, int * /*tags*/,
                  const int * /*reqs*/, const bool /*is_train*/,
                  void * /*state*/);
  bool (*backward)(int /*size*/, void ** /*ptrs*/, int * /*tags*/,
                   const int * /*reqs*/, const bool /*is_train*/,
                   void * /*state*/);
  bool (*del)(void * /*state*/);
  void *p_forward;
  void *p_backward;
  void *p_del;
};

struct CustomOpPropInfo {
  bool (*list_arguments)(char *** /*args*/, void * /*state*/);
  bool (*list_outputs)(char *** /*outputs*/, void * /*state*/);
  bool (*infer_shape)(int /*num_input*/, int * /*ndims*/,
                      unsigned ** /*shapes*/, void * /*state*/);
  bool (*declare_backward_dependency)(const int * /*out_grad*/,
                                      const int * /*in_data*/,
                                      const int * /*out_data*/,
                                      int * /*num_deps*/, int ** /*rdeps*/,
                                      void * /*state*/);
  bool (*create_operator)(const char * /*ctx*/, int /*num_inputs*/,
                          unsigned ** /*shapes*/, int * /*ndims*/,
                          int * /*dtypes*/, struct CustomOpInfo * /*ret*/,
                          void * /*state*/);
  bool (*list_auxiliary_states)(char *** /*aux*/, void * /*state*/);
  bool (*del)(void * /*state*/);
  void *p_list_arguments;
  void *p_list_outputs;
  void *p_infer_shape;
  void *p_declare_backward_dependency;
  void *p_create_operator;
  void *p_list_auxiliary_states;
  void *p_del;
};

typedef bool (*CustomOpPropCreator)(const char * /*op_type*/,
                                    const int /*num_kwargs*/,
                                    const char ** /*keys*/,
                                    const char ** /*values*/,
                                    struct CustomOpPropInfo * /*ret*/);

/*! \brief return the last error message on this thread */
MXNET_DLL const char *MXGetLastError();

/*! \brief library initialisation (embeds the Python core; idempotent) */
MXNET_DLL int MXTPULibInit();
/*! \brief notify the engine about a shutdown (parity: MXNotifyShutdown) */
MXNET_DLL int MXNotifyShutdown();
/*! \brief seed all random generators (parity: MXRandomSeed) */
MXNET_DLL int MXRandomSeed(int seed);

/* --------------------------------------------------------------- NDArray */
/*! \brief create an uninitialised handle to pass as a mutate-output (a
 *  kvstore pull target, an imperative-op output slot); reports ndim == 0
 *  from MXNDArrayGetShape until a producer fills it (parity: reference
 *  c_api.h:195-201) */
MXNET_DLL int MXNDArrayCreateNone(NDArrayHandle *out);
MXNET_DLL int MXNDArrayCreate(const mx_uint *shape, mx_uint ndim,
                              int dev_type, int dev_id, int delay_alloc,
                              NDArrayHandle *out);
MXNET_DLL int MXNDArrayFree(NDArrayHandle handle);
MXNET_DLL int MXNDArraySyncCopyFromCPU(NDArrayHandle handle,
                                       const void *data, size_t size);
MXNET_DLL int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void *data,
                                     size_t size);
MXNET_DLL int MXNDArrayGetShape(NDArrayHandle handle, mx_uint *out_dim,
                                const mx_uint **out_pdata);
MXNET_DLL int MXNDArraySave(const char *fname, mx_uint num_args,
                            NDArrayHandle *args, const char **keys);
MXNET_DLL int MXNDArrayLoad(const char *fname, mx_uint *out_size,
                            NDArrayHandle **out_arr, mx_uint *out_name_size,
                            const char ***out_names);
MXNET_DLL int MXNDArrayWaitAll();
/*! \brief block until the array's pending computation is done (parity:
 *  c_api.h:319-326; one sync covers both directions on functional arrays) */
MXNET_DLL int MXNDArrayWaitToRead(NDArrayHandle handle);
MXNET_DLL int MXNDArrayWaitToWrite(NDArrayHandle handle);
/*! \brief single-array serialization primitive (parity: c_api.h:246-270,
 *  the format under kvstore state transfer).  The returned buffer is valid
 *  until the next call on this thread. */
MXNET_DLL int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t *out_size,
                                    const char **out_buf);
MXNET_DLL int MXNDArrayLoadFromRawBytes(const void *buf, size_t size,
                                        NDArrayHandle *out);
/*! \brief host float32 copy of the data (parity: c_api.h:389).  The
 *  pointer stays valid while the handle lives; it is a copy, so it is
 *  read-only (the reference's CPU pointer is mutable). */
MXNET_DLL int MXNDArrayGetData(NDArrayHandle handle, mx_float **out_pdata);
/*! \brief create with explicit dtype (0=f32 1=f64 2=f16 3=u8 4=i32 5=i8 6=i64) */
MXNET_DLL int MXNDArrayCreateEx(const mx_uint *shape, mx_uint ndim,
                                int dev_type, int dev_id, int delay_alloc,
                                int dtype, NDArrayHandle *out);
MXNET_DLL int MXNDArrayGetDType(NDArrayHandle handle, int *out_dtype);
MXNET_DLL int MXNDArrayGetContext(NDArrayHandle handle, int *out_dev_type,
                                  int *out_dev_id);
/*! \brief slice along axis 0, [begin, end) — shares storage semantics with
 *  the source array (writes through, parity: NDArray::Slice) */
MXNET_DLL int MXNDArraySlice(NDArrayHandle handle, mx_uint begin,
                             mx_uint end, NDArrayHandle *out);
MXNET_DLL int MXNDArrayAt(NDArrayHandle handle, mx_uint idx,
                          NDArrayHandle *out);
MXNET_DLL int MXNDArrayReshape(NDArrayHandle handle, int ndim,
                               const int *dims, NDArrayHandle *out);
/*! \brief typed raw copy: buffer dtype == array dtype, size in bytes */
MXNET_DLL int MXNDArraySyncCopyFromCPUEx(NDArrayHandle handle,
                                         const void *data, size_t nbytes);
MXNET_DLL int MXNDArraySyncCopyToCPUEx(NDArrayHandle handle, void *data,
                                       size_t nbytes);

/* --------------------------------------------- imperative op invocation */
/*! \brief eager single-op execution on NDArrays (parity: MXImperativeInvoke,
 *  reference c_api.h:510).  If *num_outputs > 0, *outputs carries
 *  preallocated arrays written in place; otherwise the call allocates. */
MXNET_DLL int MXImperativeInvoke(AtomicSymbolCreator creator,
                                 int num_inputs, NDArrayHandle *inputs,
                                 int *num_outputs, NDArrayHandle **outputs,
                                 int num_params, const char **param_keys,
                                 const char **param_vals);

/* ---------------------------------------------------------------- Symbol */
MXNET_DLL int MXListAllOpNames(mx_uint *out_size, const char ***out_array);
MXNET_DLL int MXSymbolCreateFromJSON(const char *json, SymbolHandle *out);
MXNET_DLL int MXSymbolCreateFromFile(const char *fname, SymbolHandle *out);
MXNET_DLL int MXSymbolSaveToJSON(SymbolHandle symbol, const char **out_json);
MXNET_DLL int MXSymbolFree(SymbolHandle symbol);
MXNET_DLL int MXSymbolListArguments(SymbolHandle symbol, mx_uint *out_size,
                                    const char ***out_str_array);
MXNET_DLL int MXSymbolListOutputs(SymbolHandle symbol, mx_uint *out_size,
                                  const char ***out_str_array);
MXNET_DLL int MXSymbolListAuxiliaryStates(SymbolHandle symbol,
                                          mx_uint *out_size,
                                          const char ***out_str_array);
/*! \brief enumerate operator creators (parity: reference c_api.h:545);
 *  creator handles are shared with MXImperativeInvoke */
MXNET_DLL int MXSymbolListAtomicSymbolCreators(mx_uint *out_size,
                                               AtomicSymbolCreator **out);
MXNET_DLL int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                          const char **name);
/*! \brief operator reflection (parity: MXSymbolGetAtomicSymbolInfo,
 *  reference c_api.h:563) — feeds cpp-package op.h autogeneration */
MXNET_DLL int MXSymbolGetAtomicSymbolInfo(
    AtomicSymbolCreator creator, const char **name, const char **description,
    mx_uint *num_args, const char ***arg_names, const char ***arg_type_infos,
    const char ***arg_descriptions, const char **key_var_num_args);
MXNET_DLL int MXSymbolCreateAtomicSymbol(AtomicSymbolCreator creator,
                                         mx_uint num_param,
                                         const char **keys,
                                         const char **vals,
                                         SymbolHandle *out);
MXNET_DLL int MXSymbolCreateVariable(const char *name, SymbolHandle *out);
MXNET_DLL int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle *symbols,
                                  SymbolHandle *out);
/*! \brief compose an atomic symbol with its inputs, in place on the handle */
MXNET_DLL int MXSymbolCompose(SymbolHandle sym, const char *name,
                              mx_uint num_args, const char **keys,
                              SymbolHandle *args);
MXNET_DLL int MXSymbolCopy(SymbolHandle symbol, SymbolHandle *out);
MXNET_DLL int MXSymbolPrint(SymbolHandle symbol, const char **out_str);
MXNET_DLL int MXSymbolGetAttr(SymbolHandle symbol, const char *key,
                              const char **out, int *success);
MXNET_DLL int MXSymbolSetAttr(SymbolHandle symbol, const char *key,
                              const char *value);
/*! \brief flat [k0,v0,k1,v1,...] attribute list, keys "node$attr" */
/*! \brief out-node name; *success=0 for unnamed groups (parity:
 *  c_api.h:658) */
MXNET_DLL int MXSymbolGetName(SymbolHandle symbol, const char **out,
                              int *success);
/*! \brief group of the out nodes' direct inputs (parity: c_api.h:746) */
MXNET_DLL int MXSymbolGetChildren(SymbolHandle symbol, SymbolHandle *out);
/*! \brief write the graph JSON to a file (parity: c_api.h:623) */
MXNET_DLL int MXSymbolSaveToFile(SymbolHandle symbol, const char *fname);
/*! \brief attrs of the out node only, as 2*out_size key/value strings
 *  (parity: c_api.h:709) */
MXNET_DLL int MXSymbolListAttrShallow(SymbolHandle symbol, mx_uint *out_size,
                                      const char ***out);
MXNET_DLL int MXSymbolListAttr(SymbolHandle symbol, mx_uint *out_size,
                               const char ***out);
MXNET_DLL int MXSymbolGetInternals(SymbolHandle symbol, SymbolHandle *out);
MXNET_DLL int MXSymbolGetOutput(SymbolHandle symbol, mx_uint index,
                                SymbolHandle *out);
/*! \brief deprecated in the reference too: use bind + backward */
MXNET_DLL int MXSymbolGrad(SymbolHandle sym, mx_uint num_wrt,
                           const char **wrt, SymbolHandle *out);
/*! \brief bidirectional dtype inference; *complete==0 when underspecified */
MXNET_DLL int MXSymbolInferType(SymbolHandle sym, mx_uint num_args,
                                const char **keys, const int *arg_type_data,
                                mx_uint *in_type_size, const int **in_type_data,
                                mx_uint *out_type_size,
                                const int **out_type_data,
                                mx_uint *aux_type_size,
                                const int **aux_type_data, int *complete);

/*! \brief bidirectional shape inference (parity: MXSymbolInferShape).
 *  Known arg shapes arrive CSR-style: keys[i]'s shape is
 *  arg_shape_data[arg_ind_ptr[i] .. arg_ind_ptr[i+1]).  *complete==0 when
 *  the graph is underspecified (all out sizes 0 in that case). */
MXNET_DLL int MXSymbolInferShape(
    SymbolHandle sym, mx_uint num_args, const char **keys,
    const mx_uint *arg_ind_ptr, const mx_uint *arg_shape_data,
    mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
    const mx_uint ***in_shape_data, mx_uint *out_shape_size,
    const mx_uint **out_shape_ndim, const mx_uint ***out_shape_data,
    mx_uint *aux_shape_size, const mx_uint **aux_shape_ndim,
    const mx_uint ***aux_shape_data, int *complete);
/*! \brief like MXSymbolInferShape but tolerates underspecified graphs:
 *  unknown entries come back 0-dimensional (reference c_api.h partial) */
MXNET_DLL int MXSymbolInferShapePartial(
    SymbolHandle sym, mx_uint num_args, const char **keys,
    const mx_uint *arg_ind_ptr, const mx_uint *arg_shape_data,
    mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
    const mx_uint ***in_shape_data, mx_uint *out_shape_size,
    const mx_uint **out_shape_ndim, const mx_uint ***out_shape_data,
    mx_uint *aux_shape_size, const mx_uint **aux_shape_ndim,
    const mx_uint ***aux_shape_data, int *complete);

/* -------------------------------------------------------------- Executor */
/*! \brief bind a symbol into an executor (parity: MXExecutorBindEX,
 *  reference c_api.h:1040; group2ctx maps are not supported over the C
 *  boundary — bind with the Python frontend for model-parallel graphs).
 *  arg_grad_store entries may be NULL (no gradient for that argument);
 *  grad_req_type: 0=null 1=write 3=add. */
MXNET_DLL int MXExecutorBind(SymbolHandle symbol_handle, int dev_type,
                             int dev_id, mx_uint len,
                             NDArrayHandle *in_args,
                             NDArrayHandle *arg_grad_store,
                             mx_uint *grad_req_type, mx_uint aux_states_len,
                             NDArrayHandle *aux_states, ExecutorHandle *out);
/*! \brief reference signature with group2ctx maps (c_api.h:1004); maps must
 *  be empty over the C boundary — bind model-parallel graphs from Python */
MXNET_DLL int MXExecutorBindX(SymbolHandle symbol_handle, int dev_type,
                              int dev_id, mx_uint num_map_keys,
                              const char **map_keys,
                              const int *map_dev_types,
                              const int *map_dev_ids, mx_uint len,
                              NDArrayHandle *in_args,
                              NDArrayHandle *arg_grad_store,
                              mx_uint *grad_req_type, mx_uint aux_states_len,
                              NDArrayHandle *aux_states,
                              ExecutorHandle *out);
/*! \brief BindX + shared_exec memory sharing (c_api.h:1040); shared_exec
 *  must be NULL here (bucketing shares parameters through
 *  Module.bind(shared_module=) instead) */
MXNET_DLL int MXExecutorBindEX(SymbolHandle symbol_handle, int dev_type,
                               int dev_id, mx_uint num_map_keys,
                               const char **map_keys,
                               const int *map_dev_types,
                               const int *map_dev_ids, mx_uint len,
                               NDArrayHandle *in_args,
                               NDArrayHandle *arg_grad_store,
                               mx_uint *grad_req_type,
                               mx_uint aux_states_len,
                               NDArrayHandle *aux_states,
                               ExecutorHandle shared_exec,
                               ExecutorHandle *out);
MXNET_DLL int MXExecutorFree(ExecutorHandle handle);
MXNET_DLL int MXExecutorForward(ExecutorHandle handle, int is_train);
/*! \brief run the backward pass; head_grads may be NULL/len 0 for loss ops */
MXNET_DLL int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                                 NDArrayHandle *head_grads);
MXNET_DLL int MXExecutorOutputs(ExecutorHandle handle, mx_uint *out_size,
                                NDArrayHandle **out);
MXNET_DLL int MXExecutorPrint(ExecutorHandle handle, const char **out_str);
/*! \brief install a per-op monitor called with every internal op output
 *  (parity: c_api.h:1055); stats come from the one real execution */
MXNET_DLL int MXExecutorSetMonitorCallback(ExecutorHandle handle,
                                           ExecutorMonitorCallback callback,
                                           void *callback_handle);
/*! \brief register a C-implemented custom operator (parity: c_api.h:1464);
 *  reachable afterwards as Custom(..., op_type=...) from any frontend */
MXNET_DLL int MXCustomOpRegister(const char *op_type,
                                 CustomOpPropCreator creator);

/* --------------------------------------------------------------- KVStore */
MXNET_DLL int MXKVStoreCreate(const char *type, KVStoreHandle *out);
MXNET_DLL int MXKVStoreFree(KVStoreHandle handle);
MXNET_DLL int MXKVStoreInit(KVStoreHandle handle, mx_uint num,
                            const int *keys, NDArrayHandle *vals);
MXNET_DLL int MXKVStorePush(KVStoreHandle handle, mx_uint num,
                            const int *keys, NDArrayHandle *vals,
                            int priority);
MXNET_DLL int MXKVStorePull(KVStoreHandle handle, mx_uint num,
                            const int *keys, NDArrayHandle *vals,
                            int priority);
/*! \brief install a C updater applied at push time (parity:
 *  MXKVStoreSetUpdater).  The updater is called synchronously with the
 *  merged gradient and the stored weight. */
MXNET_DLL int MXKVStoreSetUpdater(KVStoreHandle handle,
                                  MXKVStoreUpdater updater,
                                  void *updater_handle);
MXNET_DLL int MXKVStoreGetType(KVStoreHandle handle, const char **type);
MXNET_DLL int MXKVStoreGetRank(KVStoreHandle handle, int *rank);
MXNET_DLL int MXKVStoreGetGroupSize(KVStoreHandle handle, int *size);
MXNET_DLL int MXKVStoreBarrier(KVStoreHandle handle);
MXNET_DLL int MXKVStoreSetBarrierBeforeExit(KVStoreHandle handle,
                                            int barrier_before_exit);
MXNET_DLL int MXKVStoreGetNumDeadNode(KVStoreHandle handle, int node_id,
                                      int *number, int timeout_sec);
/*! \brief process-role predicates (parity: c_api.h:1288-1304); driven by
 *  MXTPU_ROLE/DMLC_ROLE: every process is a worker unless the launcher
 *  says otherwise */
MXNET_DLL int MXKVStoreIsWorkerNode(int *ret);
MXNET_DLL int MXKVStoreIsServerNode(int *ret);
MXNET_DLL int MXKVStoreIsSchedulerNode(int *ret);
/*! \brief reference spelling kept verbatim (c_api.h:1243).  ``body`` is a
 *  NUL-terminated C string, so it must not contain embedded NUL bytes —
 *  for head=0 (install optimizer) use pickle protocol 0, which is ASCII
 *  (the reference's Python frontend relies on the same property). */
MXNET_DLL int MXKVStoreSendCommmandToServers(KVStoreHandle handle, int head,
                                             const char *body);
/*! \brief no-op: there are no parameter-server processes (the dist*
 *  stores arrive with the distributed slice) */
MXNET_DLL int MXKVStoreRunServer(KVStoreHandle handle);
/*! \brief set DMLC_/MXTPU_ role environment variables (parity: MXInitPSEnv) */
MXNET_DLL int MXInitPSEnv(mx_uint num_vars, const char **keys,
                          const char **vals);

/* -------------------------------------------------------------- DataIter */
MXNET_DLL int MXListDataIters(mx_uint *out_size, DataIterCreator **out);
MXNET_DLL int MXDataIterGetIterInfo(DataIterCreator creator,
                                    const char **name,
                                    const char **description);
MXNET_DLL int MXDataIterCreateIter(DataIterCreator creator, mx_uint num_param,
                                   const char **keys, const char **vals,
                                   DataIterHandle *out);
MXNET_DLL int MXDataIterFree(DataIterHandle handle);
/*! \brief advance; *out = 1 if a batch is available, 0 at end of epoch */
MXNET_DLL int MXDataIterNext(DataIterHandle handle, int *out);
MXNET_DLL int MXDataIterBeforeFirst(DataIterHandle handle);
MXNET_DLL int MXDataIterGetData(DataIterHandle handle, NDArrayHandle *out);
MXNET_DLL int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle *out);
MXNET_DLL int MXDataIterGetPadNum(DataIterHandle handle, int *pad);
MXNET_DLL int MXDataIterGetIndex(DataIterHandle handle, uint64_t **out_index,
                                 uint64_t *out_size);

/* -------------------------------------------------------------- Profiler */
/*! \brief mode 0 = symbolic ops only, 1 = all ops */
MXNET_DLL int MXSetProfilerConfig(int mode, const char *filename);
/*! \brief state 1 = run, 0 = stop */
MXNET_DLL int MXSetProfilerState(int state);
MXNET_DLL int MXDumpProfile();

/* -------------------------------------------------------------- RecordIO */
typedef void *RecordIOHandle;

MXNET_DLL int MXRecordIOWriterCreate(const char *uri, RecordIOHandle *out);
MXNET_DLL int MXRecordIOWriterFree(RecordIOHandle handle);
MXNET_DLL int MXRecordIOWriterWriteRecord(RecordIOHandle handle,
                                          const char *buf, size_t size);
MXNET_DLL int MXRecordIOWriterTell(RecordIOHandle handle, size_t *pos);
MXNET_DLL int MXRecordIOReaderCreate(const char *uri, RecordIOHandle *out);
MXNET_DLL int MXRecordIOReaderFree(RecordIOHandle handle);
/*! \brief read next record; *size == 0 at end of file */
MXNET_DLL int MXRecordIOReaderReadRecord(RecordIOHandle handle,
                                         const char **buf, size_t *size);
MXNET_DLL int MXRecordIOReaderSeek(RecordIOHandle handle, size_t pos);

#ifdef __cplusplus
}
#endif

#endif  /* MXNET_TPU_C_API_H_ */
