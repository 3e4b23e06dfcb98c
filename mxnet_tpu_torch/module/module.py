"""Module: one symbol trained on one device (counterpart:
mxnet_tpu/module/module.py).

``Module(context=None)`` runs on ``gpu(0)``; without a card it raises
``MXNetError``, as ``Predictor`` does.  ``fit`` trains through the fused
path (``_FusedFit``: one ``TrainStep`` call a batch, forward, backward and
the optimizer rule on the card) when the common case holds, and through
the executor group and the ``Updater`` otherwise or under
``MXNET_FUSED_FIT=0``; ``_start_fused_fit`` logs why.

Not ported here, each refused with ``MXNetError`` naming its slice:
several contexts, kvstore objects and the ``dist*`` kvstores, and the fused
fit's pipeline, ZeRO, elastic-resume, sharded-checkpoint and live-resize
branches (the parallel slice); the Monitor bridge (the observability
slice).

``bind(shared_module=...)`` binds onto another module's parameter, gradient
and aux tensors and shares its host dicts and optimizer: the buckets of a
``BucketingModule`` train one set of parameters.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError, atomic_write, get_env, string_types
from ..context import Context, cpu, gpu
from .. import amp as _amp
from .. import io as _io
from .. import ndarray as nd
from .. import optimizer as opt
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _update_params, load_checkpoint,
                     save_checkpoint)
from ..train import TrainStep
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup, _descs

__all__ = ["Module"]


class Module(BaseModule):
    """A symbol with its bound executor, parameters and optimizer (parity:
    mxnet_tpu.Module).  ``context``: one Context (default ``gpu(0)``)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = gpu(0)
        if isinstance(context, Context):
            context = [context]
        if len(context) != 1:
            raise MXNetError("Module over %d contexts is not ported yet: "
                             "data parallelism arrives with the parallel "
                             "slice" % len(context))
        context[0].torch_device()      # no card: MXNetError here
        self._context = list(context)
        if work_load_list is None:
            work_load_list = [1]
        assert len(work_load_list) == 1
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        input_names = data_names + label_names + list(state_names or [])
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._preload_opt_states = None
        self._loaded_opt_states = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        # (key, TrainStep) of the fused fit, kept across fit() calls
        self._fused_ts_cache = None
        # the _FusedFit whose tensors hold the live parameters mid-fit
        self._active_fused = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (parity: Module.load)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states`` (parity:
        Module.save_checkpoint)."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    # ---------------------------------------------------------------- states
    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outputs = self._exec_group.get_outputs()
        return list(zip(self._output_names, [o.shape for o in outputs]))

    def get_params(self):
        """(arg_params, aux_params): the module's host-side dicts, synced
        from the device first when training moved the parameters."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Fill the parameters from ``arg_params`` / ``aux_params`` or the
        initializer (default ``Uniform(0.01)``) on the host, then copy them
        into the executor (parity: Module.init_params)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and (arg_params is None or aux_params is None):
            initializer = Uniform(0.01)
        ex = self._exec_group.execs[0]
        if self._arg_params is None:
            self._arg_params = {
                name: nd.zeros(ex.arg_dict[name].shape, ctx=cpu(),
                               dtype=ex.arg_dict[name].dtype)
                for name in self._param_names if name in ex.arg_dict}
        if self._aux_params is None:
            self._aux_params = {
                name: nd.zeros(ex.aux_dict[name].shape, ctx=cpu(),
                               dtype=ex.aux_dict[name].dtype)
                for name in self._aux_names}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    src = cache[name]
                    if src is not arr:
                        src = src.value if isinstance(src, nd.NDArray) \
                            else nd.array(src, ctx=cpu()).value
                        arr._set_value(src.to(arr.value.dtype))
                    return
                if not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                if initializer is None:
                    return
            initializer(InitDesc(name, attrs.get(name)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # ------------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor for these input shapes on the context (parity:
        Module.bind).  With ``shared_module`` (bound, its parameters
        initialized) the executor binds onto that module's parameter,
        gradient and aux tensors, and this module takes its host
        parameter dicts and, once it has one, its optimizer: no parameter
        is copied."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new batch shapes, keeping the parameters (parity:
        Module.reshape)."""
        assert self.binded
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # -------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer and its ``Updater``; a named optimizer gets
        ``rescale_grad = 1 / batch_size`` unless given one (parity:
        Module.init_optimizer).  The fused step and the ``Updater`` read the
        same optimizer object."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if isinstance(optimizer, string_types):
            idx2name = dict(enumerate(self._exec_group.param_names))
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = \
                    1.0 / self._exec_group.batch_size
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Train with ``shared_module``'s optimizer and ``Updater`` (parity:
        Module.borrow_optimizer: a BucketingModule's buckets share one)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # ------------------------------------------------------------ computation
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One ``Updater`` pass over the parameters with gradients."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, updater=self._updater,
                       num_device=1)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        self._exec_group.set_states(states, value)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        if self._active_fused is not None:
            # mid fused fit the live parameters are the step's tensors
            self._active_fused.sync_back()
            return
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """The ``Updater``'s states, pickled, through ``atomic_write``."""
        assert self.optimizer_initialized
        with atomic_write(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        # the fused fit starts from the Updater's states only as it exported
        # them: explicitly loaded states route fit to the general path
        self._loaded_opt_states = True
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    # ------------------------------------------------- fused fit fast path
    def _start_fused_fit(self, policy=None):
        """A ``_FusedFit`` when the common case holds, else None (the
        general path), with the reason logged (parity:
        Module._start_fused_fit).

        The fused path needs: ``MXNET_FUSED_FIT`` not "0"; no state inputs,
        fixed parameters or input gradients; no explicitly loaded optimizer
        states; grad_req "write"; a rule ``TrainStep`` has (SGD, ccSGD, NAG,
        Adam, RMSProp, AdaGrad, AdaDelta).  Several contexts and the
        ``dist*`` kvstores, the reference's other two gates, raise earlier
        (the parallel slice).  ``policy`` (or ``MXNET_AMP``, read here)
        trains in mixed precision; the general path trains float32."""
        policy = _amp.resolve_policy(policy)

        def fallback(why):
            if policy is not None:
                why += " (MXNET_AMP/policy ignored: the general path " \
                       "trains f32)"
            logging.info("Module.fit: general (executor) path — %s", why)
            return None

        if get_env("MXNET_FUSED_FIT", "1") == "0":
            return fallback("MXNET_FUSED_FIT=0")
        if self._state_names or self._fixed_param_names or \
                self.inputs_need_grad:
            return fallback("states/fixed-params/inputs_need_grad")
        if self._preload_opt_states is not None or self._loaded_opt_states:
            return fallback("explicitly loaded optimizer states")
        if self._exec_group._default_grad_req != "write":
            return fallback("grad_req != 'write'")
        if getattr(self, "_ckpt_resume", None) is not None:
            _refuse("an elastic resume of the fused state", "parallel")
        try:
            return _FusedFit(self, policy)
        except MXNetError as e:
            return fallback(str(e))


def _fused_fit_key_fields(optimizer, policy):
    """The named fields of the fused fit's TrainStep cache key (parity:
    module._fused_fit_key_fields).

    The optimizer's configuration and the precision policy: a fit that
    changes either builds a new TrainStep.  ``num_update`` and
    ``begin_num_update`` are step state, not configuration.  The graph
    levers (``MXNET_NORM_CONV``, ``MXNET_STEM_FUSE``, ``MXNET_STEM_S2D``,
    ``MXNET_CONV_LAYOUT``, ``MXNET_POOL_MASK_BWD``) need no field: the port
    traces nothing, and ``executor._Lowered`` reads them at every run, so a
    toggle takes effect at the next step of the same TrainStep."""
    return {
        "optimizer": type(optimizer).__name__,
        "opt_hyper": tuple(sorted(
            (k, v) for k, v in vars(optimizer).items()
            if isinstance(v, (int, float, bool, str))
            and k not in ("num_update", "begin_num_update"))),
        "lr_mult": tuple(sorted(optimizer.lr_mult.items())),
        "wd_mult": tuple(sorted(optimizer.wd_mult.items())),
        "policy": policy.key() if policy is not None else None,
    }


def _refuse(what, slice_):
    raise MXNetError("%s is not ported yet: it arrives with the %s slice"
                     % (what, slice_))


# the Updater's state layout of each TrainStep rule (Optimizer.create_state)
def _updater_state(kind, st):
    if kind in ("sgd", "ccsgd", "nag", "adagrad"):
        return st[0] if st else None
    if kind in ("adam", "adadelta"):
        return st[0], st[1]
    return tuple(st)   # rmsprop: 1 plain, 3 centered


class _FusedFit(object):
    """The fused per-batch trainer behind ``Module.fit`` (parity:
    module._FusedFit on one device).

    It keeps the parameters, optimizer state and aux states as tensors on
    the module's device and runs one ``TrainStep`` call a batch; TrainStep
    updates them in place.  ``sync_back`` copies them out to the executor,
    the module's host dicts and the ``Updater`` (never aliases), and the
    next ``_FusedFit`` starts from those copies."""

    def __init__(self, module, policy=None):
        self._mod = module
        opt_ = module._optimizer
        fields = _fused_fit_key_fields(opt_, policy)
        key = tuple(sorted(fields.items()))
        cached = module._fused_ts_cache
        if cached is not None and cached[0] == key:
            self._ts = cached[1]
            self._ts.optimizer = opt_
            self._ts.fopt.opt = opt_
            self._ts.num_update = 0
        else:
            self._ts = TrainStep(module._symbol, opt_,
                                 data_names=tuple(module._data_names),
                                 label_names=tuple(module._label_names),
                                 policy=policy, ctx=module._context[0])
            module._fused_ts_cache = (key, self._ts)
        dev = module._context[0].torch_device()
        self._dev = dev
        # the side stream the prefetch producer copies batches on
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
            else None
        arg_params, aux_params = module.get_params()
        # copies: TrainStep updates these in place
        self._params = {n: arg_params[n].value.detach().to(dev, copy=True)
                        for n in self._ts.param_names}
        self._aux = {n: aux_params[n].value.detach().to(dev, copy=True)
                     for n in self._ts.aux_names}
        self._state = self._ts.fopt.init_state(self._params)
        self._merge_updater_state()
        self._input_names = module._data_names + module._label_names

    def _merge_updater_state(self):
        """Continue from the ``Updater``'s states (a second fit continues
        momentum and Adam's moments as the general path does) and from the
        optimizer's update count (Adam's bias correction, lr schedules)."""
        updater = self._mod._updater
        if updater is None or not updater.states:
            return
        for idx, name in enumerate(self._ts.param_names):
            st = updater.states.get(idx)
            if st is None:
                continue
            vals = st if isinstance(st, tuple) else (st,)
            vals = tuple(v for v in vals if v is not None)
            if len(vals) != len(self._state[name]):
                continue
            self._state[name] = tuple(
                v.value.detach().to(self._dev, copy=True) for v in vals)
        counts = self._mod._optimizer._index_update_count
        if counts:
            self._ts.num_update = max(counts.values())

    def _host_batch(self, data_batch):
        """DataBatch -> {input name: host tensor} in TrainStep's order."""
        arrays = list(data_batch.data) + list(data_batch.label or [])
        return {n: a.value for n, a in zip(self._input_names, arrays)}

    def _stage(self, data_batch):
        """Producer side (the DevicePrefetchIter thread): start the copies
        of the whole batch to the device on the side stream."""
        data_batch._staged = _io.StagedInputs(self._host_batch(data_batch),
                                              self._dev, self._stream)
        return data_batch

    def prefetch(self, data_iter):
        """Wrap an epoch's iterator in the device prefetcher of
        ``MXNET_DEVICE_PREFETCH``'s depth (unchanged when it is 0)."""
        depth = _io.device_prefetch_depth()
        if depth == 0:
            return data_iter
        return _io.DevicePrefetchIter(data_iter, stage=self._stage,
                                      depth=depth)

    def amp_stats(self):
        """(loss scale, overflows since the last call) under a policy, else
        None.  Reads two scalars from the device."""
        return self._ts.amp_stats()

    # the JAX package's hooks for its sharded step checkpoints, live resize
    # and the Monitor bridge: not ported yet
    def save_checkpoint(self, checkpointer, epoch=0, nbatch=0, extra=None):
        _refuse("sharded checkpoints of the live fused state", "parallel")

    def export_state(self, epoch=0, nbatch=0):
        _refuse("exporting the fused state for a live resize", "parallel")

    def apply_resize(self, man, params, opt_state, aux):
        _refuse("a live resize of the fused state", "parallel")

    def monitor_tic(self, monitor):
        _refuse("the Monitor bridge", "observability")

    def monitor_feed(self, monitor):
        _refuse("the Monitor bridge", "observability")

    def step(self, data_batch):
        """One fused step: (outputs, labels on the device) as NDArrays, for
        the metric to reduce where they are.  A staged batch is taken after
        the compute stream waits on its copies; otherwise each input moves
        in one copy."""
        staged = getattr(data_batch, "_staged", None)
        batch = staged.take() if staged is not None \
            else self._ts.shard_batch(self._host_batch(data_batch))
        self._params, self._state, self._aux, outs = self._ts(
            self._params, self._state, self._aux, batch)
        # the live parameters are ours now: get_params syncs through us
        self._mod._params_dirty = True
        self._mod._active_fused = self
        labels = [nd.NDArray(batch[n]) for n in self._mod._label_names
                  if n in batch]
        return [nd.NDArray(o) for o in outs], labels

    def sync_back(self):
        """Copy the trained state into the module: the executor's arrays,
        the host dicts of ``get_params`` and the ``Updater``'s states, each
        a copy (TrainStep writes into its tensors in place, so an alias
        would change under the next fit), and continue the optimizer's
        update counts."""
        mod = self._mod
        mod._exec_group.set_params(
            {n: nd.NDArray(v.clone()) for n, v in self._params.items()},
            {n: nd.NDArray(v.clone()) for n, v in self._aux.items()})
        for n, v in self._params.items():
            mod._arg_params[n]._set_value(v.clone())
        for n, v in self._aux.items():
            mod._aux_params[n]._set_value(v.clone())
        mod._params_dirty = False
        mod._active_fused = None
        opt_ = mod._optimizer
        for idx in range(len(self._ts.param_names)):
            opt_._index_update_count[idx] = self._ts.num_update
        opt_.num_update = max(opt_.num_update, self._ts.num_update)
        kind = self._ts.fopt.kind
        for idx, name in enumerate(self._ts.param_names):
            mod._updater.states[idx] = _updater_state(
                kind, tuple(nd.NDArray(s.clone())
                            for s in self._state[name]))
