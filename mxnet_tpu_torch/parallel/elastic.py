"""Failure detection and elastic resume (counterpart:
mxnet_tpu/parallel/elastic.py).

Every process holds a replica, so recovery is a resume from a checkpoint:
- detection: ``health_check`` is a bounded barrier on the store, False when
  a peer does not arrive in time; ``num_dead_node`` keeps the reference's
  API shape (0, or the other ranks' count);
- recovery: the launcher (``python -m mxnet_tpu_torch.launch
  --max-restarts``) respawns the world with ``MXTPU_RESTART_COUNT``
  incremented (``is_recovery``), and ``fit_elastic`` resumes from the
  newest checkpoint of either format: a per-epoch ``prefix-NNNN.params``
  (with its ``.states``), or a sharded step checkpoint
  (``MXNET_CKPT_EVERY_N_STEPS=N``: ``checkpoint.Checkpointer`` every N
  updates of the fused fit), which restores parameters, optimizer state,
  the loss scale and the update count and skips the batches of the
  interrupted epoch already consumed.

The live resize (the ``--elastic`` supervisor's ``MXNET_ELASTIC_PLAN``, a
respawned rank joining a running world) arrives with the live-resize part
of the distributed slice; ``fit_elastic`` raises while it is set.
"""
from __future__ import annotations

import glob
import logging
import os
import re
import threading

from ..base import MXNetError, get_env

__all__ = ["health_check", "num_dead_node", "is_recovery",
           "latest_checkpoint", "resume_or_start", "fit_elastic"]

_LOG = logging.getLogger(__name__)

_health_lock = threading.Lock()
_health_generation = [0]


def health_check(timeout=30.0, name="health"):
    """True when every process reaches a bounded barrier on the store
    within ``timeout`` seconds.  Collective: every rank calls it equally
    often (a generation a call names the barrier)."""
    from . import dist
    with _health_lock:
        _health_generation[0] += 1
        barrier_name = "%s-%d" % (name, _health_generation[0])
    return dist.membership_barrier(barrier_name,
                                   timeout_ms=max(1, int(timeout * 1000)))


def num_dead_node(node_id=0, timeout=30):
    """Unreachable nodes (reference kvstore.h:242): 0 when the world is
    healthy, else the other ranks' count; 0 in a world of 1."""
    from . import dist
    world, _ = dist.peer_world()
    if world <= 1:
        return 0
    return 0 if health_check(timeout=timeout) else world - 1


def is_recovery():
    """True when this process is a respawn of the launcher."""
    return int(get_env("MXTPU_RESTART_COUNT", "0") or "0") > 0


# four or more digits: "%04d" widens past epoch 9999
_EPOCH_RE = re.compile(r"-(\d{4,})\.params$")

# the epoch-end barrier ids are unique a fit_elastic call
_barrier_seq_lock = threading.Lock()
_barrier_seq = [0]


def latest_checkpoint(prefix):
    """The newest epoch of the ``prefix-%04d.params`` checkpoints, or None;
    a truncated or unreadable candidate (``ndarray.validate_file``) is
    skipped with a warning."""
    from .. import ndarray as nd
    epochs = []
    for path in glob.glob("%s-*.params" % prefix):
        m = _EPOCH_RE.search(path)
        if m:
            epochs.append((int(m.group(1)), path))
    for e, path in sorted(epochs, reverse=True):
        if nd.validate_file(path):
            return e
        _LOG.warning("latest_checkpoint: skipping unreadable or truncated "
                     "candidate %s", path)
    return None


def resume_or_start(module, prefix, load_optimizer_states=False):
    """Load the newest epoch checkpoint into ``module`` (bound) if there is
    one; returns the epoch to pass as ``begin_epoch`` (0 without one)."""
    epoch = latest_checkpoint(prefix)
    if epoch is None:
        return 0
    from .. import model as model_mod
    _sym, arg_params, aux_params = model_mod.load_checkpoint(prefix, epoch)
    module.set_params(arg_params, aux_params)
    if load_optimizer_states and getattr(module, "optimizer_initialized",
                                         False):
        states = "%s-%04d.states" % (prefix, epoch)
        if os.path.exists(states):
            module.load_optimizer_states(states)
    return epoch


class _ResumeIter(object):
    """A DataIter whose first epoch skips the ``skip`` batches that the
    interrupted run consumed; later epochs (after ``reset``) pass
    through."""

    def __init__(self, it, skip):
        self._it = it
        self._skip = int(skip)
        self._first = True

    def __iter__(self):
        inner = iter(self._it)
        if self._first:
            self._first = False
            for _ in range(self._skip):
                try:
                    next(inner)
                except StopIteration:
                    break
        return inner

    def reset(self):
        self._first = False
        self._it.reset()

    def __getattr__(self, name):
        return getattr(self._it, name)


def _resume_point(prefix):
    """The newest resume point of either format, or None: an epoch
    checkpoint ``NNNN`` is position ``(NNNN, 0)``, a step checkpoint saved
    at ``(epoch E, batch B)`` resumes at ``(E, B + 1)``; the later wins."""
    from .. import checkpoint as _ckpt
    epoch = latest_checkpoint(prefix)
    mono = None if epoch is None else ("mono", (epoch, 0), epoch)
    sharded_path = _ckpt.latest_sharded(prefix)
    if sharded_path is not None:
        man = _ckpt.load_manifest(sharded_path)
        pos = (int(man["epoch"]), int(man["nbatch"]) + 1)
        if mono is None or pos > mono[1]:
            return ("sharded", pos, sharded_path, man)
    return mono


def fit_elastic(module, train_data, prefix, num_epoch, eval_data=None,
                save_optimizer_states=True, **fit_kwargs):
    """``Module.fit`` with checkpoints and an automatic resume (parity:
    elastic.fit_elastic without the live resize).

    A fresh start trains epochs [0, num_epoch); a rerun resumes from the
    newest checkpoint.  Every epoch ends with ``prefix-NNNN.params`` (and
    ``.states``), written by rank 0 while the other ranks wait at a store
    barrier; with ``MXNET_CKPT_EVERY_N_STEPS=N`` (read at the call) the
    fused fit also writes a sharded checkpoint every N updates through an
    asynchronous ``Checkpointer``, which is closed (every save on disk, a
    writer failure raised) before the call returns.  A step checkpoint's
    resume restores the full fused state through ``module._ckpt_resume``;
    on the general path only the parameters load, with a warning."""
    from .. import callback as callback_mod
    from .. import checkpoint as _ckpt
    if get_env("MXNET_ELASTIC_PLAN"):
        raise MXNetError("MXNET_ELASTIC_PLAN (the --elastic supervisor's "
                         "live resize) is not ported yet: it arrives with "
                         "the live-resize part of the distributed slice")
    every = get_env("MXNET_CKPT_EVERY_N_STEPS", None, typ=int)
    begin = 0
    skip = 0
    resume = _resume_point(prefix)
    if resume is not None and resume[0] == "mono":
        from .. import model as model_mod
        epoch = resume[2]
        _, arg_params, aux_params = model_mod.load_checkpoint(prefix, epoch)
        # the checkpoint wins over caller-given parameters, and force_init
        # makes an already initialised module load it
        fit_kwargs["arg_params"] = arg_params
        fit_kwargs["aux_params"] = aux_params
        fit_kwargs["force_init"] = True
        begin = epoch
        states = "%s-%04d.states" % (prefix, epoch)
        if save_optimizer_states and os.path.exists(states):
            module._preload_opt_states = states
    elif resume is not None:
        _kind, (begin, skip), sharded_path, man = resume
        man, params, opt_st, aux = _ckpt.load_sharded(sharded_path)
        fit_kwargs["arg_params"] = params
        fit_kwargs["aux_params"] = aux
        fit_kwargs["force_init"] = True
        module._ckpt_resume = {"path": sharded_path, "man": man,
                               "params": params, "opt_state": opt_st,
                               "aux": aux}
        _LOG.info("fit_elastic: resuming from sharded checkpoint %s (epoch "
                  "%d, batch %d, step %d)", sharded_path, begin, skip,
                  man["step"])
    if begin >= num_epoch:
        module._ckpt_resume = None
        return module
    cb = fit_kwargs.pop("epoch_end_callback", None)
    ckpt_cb = callback_mod.do_checkpoint(prefix)
    world = _ckpt._world()
    with _barrier_seq_lock:
        _barrier_seq[0] += 1
        barrier_run = _barrier_seq[0]

    def _ckpt_with_states(iter_no, sym, arg, aux):
        if world == 1 or _ckpt._rank() == 0:
            ckpt_cb(iter_no, sym, arg, aux)
            if save_optimizer_states:
                module.save_optimizer_states("%s-%04d.states"
                                             % (prefix, iter_no + 1))
        if world > 1:
            from . import dist
            # a store barrier (the checkpoint writer's thread may be in one
            # of its own), bounded: a peer gone at the epoch's end is an
            # error here, not a hang
            dist.coordination_barrier("elastic-ckpt-%d-%d"
                                      % (barrier_run, iter_no),
                                      timeout_ms=300000)

    if cb is None:
        extra = []
    elif isinstance(cb, (list, tuple)):
        extra = list(cb)
    else:
        extra = [cb]
    batch_cbs = fit_kwargs.pop("batch_end_callback", None)
    batch_cbs = [] if batch_cbs is None else (
        list(batch_cbs) if isinstance(batch_cbs, (list, tuple))
        else [batch_cbs])
    ckptr = None
    if every:
        ckptr = _ckpt.Checkpointer(prefix)
        batch_cbs = batch_cbs + [callback_mod.do_step_checkpoint(
            module, ckptr, every, resume_epoch=begin, nbatch_offset=skip)]
    data = _ResumeIter(train_data, skip) if skip else train_data
    try:
        module.fit(data, eval_data=eval_data, num_epoch=num_epoch,
                   begin_epoch=begin,
                   epoch_end_callback=[_ckpt_with_states] + extra,
                   batch_end_callback=batch_cbs or None, **fit_kwargs)
    finally:
        if ckptr is not None:
            ckptr.close()
    if getattr(module, "_ckpt_resume", None) is not None:
        # the fused fit never engaged: only the parameters were restored
        module._ckpt_resume = None
        _LOG.warning(
            "fit_elastic: the sharded resume restored the parameters only: "
            "the fused fit did not engage, so the optimizer state and the "
            "update count started afresh (general-path resume)")
    return module
