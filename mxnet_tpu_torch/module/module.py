"""Module: one symbol trained on one device or data-parallel over several
(counterpart: mxnet_tpu/module/module.py).

``Module(context=None)`` runs on ``gpu(0)``; without a card it raises
``MXNetError``, as ``Predictor`` does.  ``fit`` trains through the fused
path (``_FusedFit``: one ``TrainStep`` call a batch, forward, backward and
the optimizer rule on the card) when the common case holds, and through
the executor group and the ``Updater`` otherwise or under
``MXNET_FUSED_FIT=0``; ``_start_fused_fit`` logs why.  Over a list of
contexts the group binds one executor a context and splits each batch by
the workload; ``init_optimizer(kvstore=...)`` makes the store
(``model._create_kvstore``) and ``update`` sums the gradients through it or
in process (``model._update_params*``).

Observability (parity: the JAX package): while telemetry records, ``fit``
takes the general path so that the step splits into spans, unless
``MXNET_TELEMETRY_FUSED=1`` keeps the fused path (one ``fused_step`` span
a batch); a ``Monitor`` with the default statistic rides the fused path
(parameter rows from norms the step computes on the card:
``_FusedFit.monitor_tic`` / ``monitor_feed``), a custom ``stat_func``
takes the general path; ``install_monitor`` hooks every executor.

A ``dist*`` store trains on the general path (the reference's gate), one
collective a key a batch; ``init_optimizer`` scales the batch size by the
world's size for the ``_sync`` types.  The fused fit writes sharded step
checkpoints of its live state (``_FusedFit.save_checkpoint``) and resumes
from one (``module._ckpt_resume``, set by ``parallel.elastic.fit_elastic``).
``MXNET_ZERO=<level>`` trains the fused fit through one ``TrainStep`` over
a ``dp`` mesh of the world at that ZeRO level: under ``launch.py`` every
rank reads the same global batches and steps on its rows of each, so the
fit means what the JAX package's one-process fit over its devices means
(the outputs are gathered for the metric).  Not ported here, refused with
``MXNetError`` naming its part of the distributed slice: the fused fit's
pipeline branch and the live resize.

``bind(shared_module=...)`` binds onto another module's parameter, gradient
and aux tensors and shares its host dicts and optimizer: the buckets of a
``BucketingModule`` train one set of parameters.
"""
from __future__ import annotations

import logging
import math

import torch

from ..base import MXNetError, atomic_write, get_env, string_types
from ..context import Context, cpu, gpu
from .. import amp as _amp
from .. import io as _io
from .. import ndarray as nd
from .. import optimizer as opt
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from ..parallel import dist as _dist
from ..parallel import mesh as _mesh
from ..parallel.placement import normalize_zero
from ..train import TrainStep, _to_device
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup, _descs

__all__ = ["Module"]


class Module(BaseModule):
    """A symbol with its bound executors, parameters and optimizer (parity:
    mxnet_tpu.Module).  ``context``: a Context (default ``gpu(0)``) or a
    list of them, one executor each (the same context may repeat);
    ``work_load_list``: each context's share of a batch."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = gpu(0)
        if isinstance(context, Context):
            context = [context]
        for ctx in context:
            ctx.torch_device()         # no card: MXNetError here
        self._context = list(context)
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        assert len(work_load_list) == len(self._context)
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
        """The store (``model._create_kvstore``), the optimizer and its
        ``Updater``, or the optimizer installed on the store when the
        update runs there; a named optimizer gets ``rescale_grad = 1 /
        batch_size`` (the whole batch over every context, times the
        world's size for the ``dist*_sync*`` stores) unless given one
        (parity: Module.init_optimizer).  The fused step and the
        ``Updater`` read the same optimizer object."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if isinstance(optimizer, string_types):
            n_dev = len(self._context)
            names = self._exec_group.param_names
            if update_on_kvstore:
                idx2name = dict(enumerate(names))
            else:
                # the Updater's index of device k's copy: i * n_dev + k
                idx2name = {i * n_dev + k: n for k in range(n_dev)
                            for i, n in enumerate(names)}
            batch_size = self._exec_group.batch_size
            if kvstore and "dist" in kvstore.type and \
                    "_sync" in kvstore.type:
                batch_size *= kvstore.num_workers
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._exec_group.param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
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
        """One update of every parameter with a gradient: through the store
        when the update runs there, else the gradients summed over the
        devices (by the store, or in process) and each device's copy
        updated by the ``Updater`` (parity: Module.update)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

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
        """The ``Updater``'s states (the store's when the update runs
        there), pickled, through ``atomic_write``."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with atomic_write(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        # the fused fit starts from the Updater's states only as it exported
        # them: explicitly loaded states route fit to the general path
        self._loaded_opt_states = True
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def install_monitor(self, mon):
        """Hook ``mon`` into every executor of the group (parity:
        Module.install_monitor)."""
        assert self.binded
        self._exec_group.install_monitor(mon)

    # ------------------------------------------------- fused fit fast path
    def _start_fused_fit(self, policy=None, monitor=None):
        """A ``_FusedFit`` when the common case holds, else None (the
        general path), with the reason logged (parity:
        Module._start_fused_fit).

        The fused path needs: ``MXNET_FUSED_FIT`` not "0"; one context (a
        module over several trains on the general path, "multi-context
        binding"); no state inputs, fixed parameters or input gradients; no
        explicitly loaded optimizer states; grad_req "write"; a rule
        ``TrainStep`` has (SGD, ccSGD, NAG, Adam, RMSProp, AdaGrad,
        AdaDelta); no ``dist*`` store (it sums across processes, which the
        one-process step would bypass).  ``policy`` (or
        ``MXNET_AMP``, read here) trains in mixed precision; the general
        path trains float32.

        ``monitor`` rides the fused path when its stat_func is the default
        RMS (its rows are then the parameters' RMS, computed on the card
        by the step); a custom stat_func is host Python over every node
        output and takes the general path.  While telemetry records, the
        general path runs so that the step splits into spans, unless
        ``MXNET_TELEMETRY_FUSED=1``."""
        from .. import monitor as _mon_mod
        from .. import telemetry as _tel
        policy = _amp.resolve_policy(policy)
        zero_req = get_env("MXNET_ZERO", "") not in ("", "0")

        def fallback(why):
            if policy is not None:
                why += " (MXNET_AMP/policy ignored: the general path " \
                       "trains f32)"
            if zero_req:
                why += " (MXNET_ZERO ignored: the general path " \
                       "replicates params/grads/optimizer state)"
            logging.info("Module.fit: general (executor) path — %s", why)
            return None

        if get_env("MXNET_FUSED_FIT", "1") == "0":
            return fallback("MXNET_FUSED_FIT=0")
        if monitor is not None:
            if monitor.stat_func is not _mon_mod._rms:
                return fallback(
                    "Monitor with a custom stat_func cannot be served "
                    "from the fused step's on-device stats (the fused "
                    "step samples the default RMS of the parameters "
                    "only)")
            logging.info(
                "Module.fit: Monitor served from the fused step's "
                "on-device parameter norms (parameter rows; per-op "
                "activation streaming needs the general path — "
                "MXNET_FUSED_FIT=0)")
        if _tel.enabled() and get_env("MXNET_TELEMETRY_FUSED", "0") != "1":
            # the fused step cannot be split into forward/backward/update
            # spans; telemetry asks for that breakdown, so the general path
            # runs.  MXNET_TELEMETRY_FUSED=1 keeps the fused path, with one
            # fused_step span a batch
            return fallback("telemetry step breakdown active "
                            "(MXNET_TELEMETRY_FUSED=1 keeps the fused path)")
        if len(self._context) != 1:
            return fallback("multi-context binding")
        if self._state_names or self._fixed_param_names or \
                self.inputs_need_grad:
            return fallback("states/fixed-params/inputs_need_grad")
        if self._preload_opt_states is not None or self._loaded_opt_states:
            return fallback("explicitly loaded optimizer states")
        if self._exec_group._default_grad_req != "write":
            return fallback("grad_req != 'write'")
        if self._kvstore is not None and "dist" in self._kvstore.type:
            return fallback("dist kvstore")
        try:
            return _FusedFit(self, policy)
        except MXNetError as e:
            if zero_req:
                # a ZeRO level asked for must not train replicated instead
                raise
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
        "zero": get_env("MXNET_ZERO", None, typ=int),
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
        # MXNET_ZERO=<level>: one step over a dp mesh of the world, read
        # here and carried in the key; checked at every dispatch, so a
        # re-bound batch size meets this error, not a failing step
        zero = normalize_zero(fields["zero"] or 0)
        if zero:
            world = _dist.num_workers()
            bs = module._exec_group.batch_size
            if bs % world:
                raise MXNetError(
                    "MXNET_ZERO=%d shards each batch over the %d rank(s) of "
                    "the world; batch size %d is not divisible: pick a "
                    "divisible batch size" % (zero, world, bs))
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
                                 mesh=_mesh.make_mesh({"dp": -1})
                                 if zero else None, zero=zero,
                                 policy=policy, ctx=module._context[0])
            module._fused_ts_cache = (key, self._ts)
        # the fit loop emits the AMP telemetry (train_loss_scale, the
        # gauge and the counter at the scalar_due cadence): one read a
        # step, not two
        self._ts._amp_emit = False
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
        # element counts for the Monitor bridge (RMS = norm / sqrt(size))
        self._param_sizes = {n: int(v.numel())
                             for n, v in self._params.items()}
        self._state = self._ts.fopt.init_state(self._params)
        self._merge_updater_state()
        if self._ts.zero:
            # the plan's rows of the logical state (and level-3 parameters)
            self._params, self._state, self._aux = \
                self._ts.place_checkpoint(self._params, self._state,
                                          self._aux, device=dev)
        self._input_names = module._data_names + module._label_names
        resume = getattr(module, "_ckpt_resume", None)
        if resume is not None:
            self._resume(resume)

    def _resume(self, resume):
        """The elastic resume hook (``parallel.elastic.fit_elastic`` sets
        ``module._ckpt_resume``): parameters, optimizer state, aux states,
        the loss-scale state and the update count restored from a sharded
        checkpoint over the placement above, from the path or from the
        one ``load_sharded`` fit_elastic already did (the dict form).
        The optimizer's counters are set to the restored step, so lr
        schedules and Adam's bias correction continue exactly."""
        from .. import checkpoint as _ckpt
        mod = self._mod
        mod._ckpt_resume = None
        if isinstance(resume, dict):
            self._params, self._state, self._aux, _man = \
                _ckpt.restore_loaded(self._ts, resume["man"],
                                     resume["params"], resume["opt_state"],
                                     resume["aux"], device=self._dev,
                                     where=resume["path"])
        else:
            self._params, self._state, self._aux, _man = \
                _ckpt.restore_into(self._ts, resume, device=self._dev)
        opt_ = mod._optimizer
        for idx in range(len(self._ts.param_names)):
            opt_._index_update_count[idx] = self._ts.num_update
        opt_.num_update = max(opt_.num_update, self._ts.num_update)

    def _updater(self):
        """The module's ``Updater``, or the store's when the update runs
        there (one context with a ``KVStore`` object)."""
        mod = self._mod
        if mod._updater is None and mod._kvstore is not None:
            return mod._kvstore._updater
        return mod._updater

    def _merge_updater_state(self):
        """Continue from the ``Updater``'s states (a second fit continues
        momentum and Adam's moments as the general path does) and from the
        optimizer's update count (Adam's bias correction, lr schedules)."""
        updater = self._updater()
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

    def step_flops(self):
        """Model FLOPs of one fused step, counted from the graph (the fit
        loop's MFU numerator), or None before the first step."""
        return self._ts.step_flops()

    # ------------------------------------------------------ monitor bridge
    def monitor_tic(self, monitor):
        """Monitor bridge, tic half: the monitor armed itself for this
        batch — the step samples the parameters' squared norms on the
        card."""
        if monitor is not None and monitor._armed:
            self._ts._mon_force = True

    def monitor_feed(self, monitor):
        """Monitor bridge, toc half: the sampled step's parameter norms
        become the monitor's ``(step, name, stat)`` rows — the RMS
        (norm / sqrt(size)), the default stat — so ``toc()`` and
        ``toc_print()`` render and stream them as on the general path."""
        if monitor is None or not monitor._armed:
            return
        entry = self.last_monitor_entry()
        if entry is None:
            return
        for name, norm in sorted((entry.get("param_norms") or {}).items()):
            if not monitor._name_ok(name):
                continue
            size = self._param_sizes.get(name)
            if size:
                monitor._rows.append((monitor._armed_step, name,
                                      norm / math.sqrt(size)))

    def last_monitor_entry(self):
        """The entry the most recent step published, or None when that
        step did not sample."""
        entry = self._ts._last_mon_entry
        if entry is None or entry.get("update") != self._ts.num_update - 1:
            return None
        return entry

    # ---------------------------------------------------- checkpoint hooks
    def num_update(self):
        """The live update count (the step axis of the step-interval
        checkpoints)."""
        return self._ts.num_update

    def save_checkpoint(self, checkpointer, epoch=0, nbatch=0, extra=None):
        """Snapshot the live fused state (parameters, optimizer state, aux
        states, loss scale, update count) through ``checkpointer`` (a
        ``checkpoint.Checkpointer``): the host copy here, the shard files
        on its writer thread.  Returns the checkpoint's directory."""
        return checkpointer.save(self._ts, self._params, self._state,
                                 self._aux, epoch=epoch, nbatch=nbatch,
                                 extra=extra)

    # the JAX package's live-resize hooks: not ported yet
    def export_state(self, epoch=0, nbatch=0):
        _refuse("exporting the fused state for a live resize",
                "live-resize part of the distributed")

    def apply_resize(self, man, params, opt_state, aux):
        _refuse("a live resize of the fused state",
                "live-resize part of the distributed")

    def step(self, data_batch):
        """One fused step: (outputs, labels on the device) as NDArrays, for
        the metric to reduce where they are.  A staged batch is taken after
        the compute stream waits on its copies; otherwise each input moves
        in one copy."""
        staged = getattr(data_batch, "_staged", None)
        ts = self._ts
        names = self._mod._label_names
        if staged is not None:
            # the global batch: on a mesh the step takes this rank's rows
            batch = labelled = staged.take()
        else:
            # only this rank's rows cross, but for the metric's labels
            host = self._host_batch(data_batch)
            batch = labelled = ts.shard_batch(host)
            if ts._dp > 1:
                labelled = _to_device({n: host[n] for n in names
                                       if n in host}, self._dev)
        self._params, self._state, self._aux, outs = self._ts(
            self._params, self._state, self._aux, batch)
        if ts._dp > 1:
            # the metric reads the whole batch's outputs
            outs = [_dist.all_gather_batch(o.contiguous(), ts._group,
                                           ts._dp) for o in outs]
        # the live parameters are ours now: get_params syncs through us
        self._mod._params_dirty = True
        self._mod._active_fused = self
        labels = [nd.NDArray(labelled[n]) for n in names if n in labelled]
        return [nd.NDArray(o) for o in outs], labels

    def sync_back(self):
        """Copy the trained state into the module: the executor's arrays,
        the host dicts of ``get_params``, a store's values and the
        ``Updater``'s states, each a copy (TrainStep writes into its
        tensors in place, so an alias would change under the next fit),
        and continue the optimizer's update counts."""
        mod = self._mod
        # logical tensors from the ZeRO rows (the identity at level 0)
        params = self._ts.gather_params(self._params)
        opt_state = self._ts.gather_state(self._state)
        mod._exec_group.set_params(
            {n: nd.NDArray(v.clone()) for n, v in params.items()},
            {n: nd.NDArray(v.clone()) for n, v in self._aux.items()})
        for n, v in params.items():
            mod._arg_params[n]._set_value(v.clone())
        for n, v in self._aux.items():
            mod._aux_params[n]._set_value(v.clone())
        if mod._kvstore is not None:
            # the store's values are what a later update pulls
            for idx, n in enumerate(self._ts.param_names):
                if idx in mod._kvstore._store:
                    mod._kvstore._store[idx]._set_value(params[n])
        mod._params_dirty = False
        mod._active_fused = None
        opt_ = mod._optimizer
        for idx in range(len(self._ts.param_names)):
            opt_._index_update_count[idx] = self._ts.num_update
        opt_.num_update = max(opt_.num_update, self._ts.num_update)
        kind = self._ts.fopt.kind
        updater = self._updater()
        for idx, name in enumerate(self._ts.param_names):
            updater.states[idx] = _updater_state(
                kind, tuple(nd.NDArray(s.clone())
                            for s in opt_state[name]))
